"""Interactive text generation.

Port of ``tasks/infer/infer_text.py``: one process, one model, prompts read
from stdin, one output line each. ``generate`` decodes through the KV cache
(``models/decode.py::greedy_generate``, greedy or temperature/top-k
sampling) where the dialect has a cached decode, and otherwise (MLA and DSA
families) re-scores a fixed window greedily, one full forward a token, as
the reference does. It runs on the card unless the config asks for the CPU
(``train.platform: cpu``)::

    echo "hello there" | python -m veomni_tpu_torch.tasks.infer_text cfg.yaml
    echo "5 17 3" | python -m veomni_tpu_torch.tasks.infer_text \\
        --model.config_path=<hf dir> --train.platform=cpu

``model.config_path`` (config.json; or ``model.config_overrides`` with a
``model_type``) names the model and ``model.model_path`` its safetensors
(random weights from seed 0 without one); ``model.tokenizer_path`` a local
HF tokenizer (``tokenizer.json``), without which a prompt is
whitespace-separated token ids and the output an id list. Env knobs:
INFER_TEMPERATURE, INFER_TOP_K (sampling; greedy by default).
"""

from __future__ import annotations

import os
import sys
from typing import List, Optional

import torch

from veomni_tpu_torch.arguments import VeOmniArguments, parse_args
from veomni_tpu_torch.models.auto import build_config, build_foundation_model, build_tokenizer


@torch.no_grad()
def generate(model, cfg, input_ids, max_new_tokens: int = 64, eos_id: int = -1,
             temperature: float = 0.0, top_k: int = 0, seed: int = 0) -> List[int]:
    """Prompt ids -> prompt + generated ids (trimmed at eos) with the
    ``Transformer`` ``model``: the cached decode where ``cfg`` supports it,
    else the fixed-window greedy re-scoring fallback."""
    from veomni_tpu_torch.models.decode import greedy_generate, supports_cached_decode

    if supports_cached_decode(cfg):
        return greedy_generate(model, cfg, input_ids, max_new_tokens=max_new_tokens,
                               eos_id=eos_id, temperature=temperature, top_k=top_k, seed=seed)
    ids = [int(t) for t in input_ids]
    total = len(ids) + max_new_tokens
    dev = model.embed_tokens.device
    tokens = torch.zeros((1, total), dtype=torch.long, device=dev)
    tokens[0, :len(ids)] = torch.tensor(ids, device=dev)
    positions = torch.arange(total, device=dev)[None]
    for _ in range(max_new_tokens):
        length = len(ids)
        segments = (torch.arange(total, device=dev) < length).long()[None]
        nxt = int(model.forward_logits(tokens, positions, segments)[0, length - 1].argmax())
        ids.append(nxt)
        tokens[0, length] = nxt
        if nxt == eos_id:
            break
    return ids


def build(args):
    """(model, config, tokenizer or None) the arguments name, on the run's
    device."""
    from veomni_tpu_torch.trainer.base import resolve_platform

    m = args.model
    device = resolve_platform(args.train.platform)
    if m.config_path:
        fm = build_foundation_model(m.config_path, weights_path=m.model_path or None,
                                    device=device)
    else:
        overrides = dict(m.config_overrides)
        fm = build_foundation_model(None, weights_path=m.model_path or None, device=device,
                                    config=build_config(overrides.pop("model_type", ""),
                                                        **overrides))
    if fm.module is None:
        fm.init(torch.Generator(device=device).manual_seed(0), device=device)
    tokenizer = build_tokenizer(m.tokenizer_path) if m.tokenizer_path else None
    return fm.module, fm.config, tokenizer


def main(argv: Optional[List[str]] = None) -> None:
    args = parse_args(VeOmniArguments, argv)
    model, cfg, tokenizer = build(args)
    print("enter prompt (ctrl-d to exit):", flush=True)
    for line in sys.stdin:
        prompt = line.strip()
        if not prompt:
            continue
        ids = tokenizer(prompt)["input_ids"] if tokenizer else [int(x) for x in prompt.split()]
        eos = tokenizer.eos_token_id if tokenizer else None
        out = generate(model, cfg, ids, eos_id=-1 if eos is None else eos,
                       temperature=float(os.environ.get("INFER_TEMPERATURE", 0)),
                       top_k=int(os.environ.get("INFER_TOP_K", 0)))
        print(tokenizer.decode(out) if tokenizer else out, flush=True)


if __name__ == "__main__":
    main()

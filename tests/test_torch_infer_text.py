"""The port's ``tasks/infer_text.py`` against the reference's
``tasks/infer/infer_text.py``, on the CPU, in f32.

* ``generate()`` on both of its branches gives the reference's ids: the
  cached decode on a qwen3 toy (greedy, a sampled draw, an eos that ends
  it early) and the fixed-window greedy re-scoring on a deepseek MLA toy
  (no cached decode). The reference's MLA rope pairs the interleaved
  rotation with the concatenated-halves tables (ROADMAP.md queue 3,
  diverges on purpose); its side is run with the interleaved tables the
  port uses, as ``tests/test_torch_deepseek.py`` runs it.
* ``main()`` reads prompts from stdin through the byte-fallback fixture
  tokenizer (``tests/fixtures/tokenizers/bytefallback``) and prints the
  decoded ``generate()`` of each.
"""

import functools
import importlib.util
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import veomni_tpu.ops as jops
from veomni_tpu.models import TransformerConfig as JaxConfig
from veomni_tpu.models import build_foundation_model
from veomni_tpu_torch.models import Transformer, TransformerConfig
from veomni_tpu_torch.models.jax_weights import load_jax_params
from veomni_tpu_torch.tasks import infer_text
from test_torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QWEN3 = dict(model_type="qwen3", vocab_size=128, hidden_size=64, intermediate_size=128,
             num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2, head_dim=16,
             qk_norm=True)
# tests/test_torch_deepseek.py's deepseek_v3 toy at 2 layers (a dense, an MoE)
MLA = dict(model_type="deepseek_v3", vocab_size=128, hidden_size=64, intermediate_size=112,
           num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=4,
           tie_word_embeddings=False, kv_lora_rank=16, qk_nope_head_dim=16, qk_rope_head_dim=8,
           v_head_dim=16, num_experts=8, num_experts_per_tok=2, moe_intermediate_size=32,
           n_shared_experts=1, n_group=2, topk_group=1, first_k_dense_replace=1,
           rope_interleave=True, q_lora_rank=24, scoring_func="sigmoid", norm_topk_prob=True,
           routed_scaling_factor=1.5)


def _reference():
    """The reference's ``tasks/infer/infer_text.py`` as a module (its
    directory is no package)."""
    spec = importlib.util.spec_from_file_location(
        "reference_infer_text", os.path.join(REPO, "tasks", "infer", "infer_text.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@functools.lru_cache(maxsize=None)
def _models(name):
    fields = {"qwen3": QWEN3, "mla": MLA}[name]
    jcfg = JaxConfig(dtype=jnp.float32, **fields)
    fm = build_foundation_model(config=jcfg)
    params = fm.family.init_params(jax.random.PRNGKey(0), jcfg)
    cfg = TransformerConfig(dtype=torch.float32, **fields)
    model = Transformer(cfg, None, device="cpu")
    load_jax_params(model, jax.tree.map(np.asarray, params))
    return fm, params, model, cfg


@pytest.fixture(autouse=True, scope="module")
def _release_models():
    yield
    _models.cache_clear()


def _prompt(n, seed):
    return [int(t) for t in np.random.default_rng(seed).integers(1, 128, n)]


@pytest.mark.parametrize("case", [
    ("qwen3", dict(max_new_tokens=12)),
    ("qwen3", dict(max_new_tokens=12, temperature=0.9, top_k=20, seed=5)),
    ("qwen3", "eos"),
    ("mla", dict(max_new_tokens=8)),
], ids=["cached-greedy", "cached-sampled", "cached-eos", "mla-rescoring"])
def test_generate_equals_the_reference(case):
    name, kw = case
    fm, params, model, cfg = _models(name)
    prompt = _prompt(9, seed=1)
    ref_mod = _reference()
    if kw == "eos":  # the third greedy token as eos ends the stream there
        eos = ref_mod.generate(fm, params, prompt, max_new_tokens=6)[len(prompt) + 2]
        kw = dict(max_new_tokens=12, eos_id=eos)
    orig = jops.rotary_tables
    if name == "mla":
        jops.rotary_tables = functools.partial(orig, interleaved=True)
    try:
        want = ref_mod.generate(fm, params, prompt, **kw)
    finally:
        jops.rotary_tables = orig
    got = infer_text.generate(model, cfg, prompt, **kw)
    assert got == want
    assert got[:len(prompt)] == prompt and len(got) > len(prompt)
    if "eos_id" in kw:
        assert got[-1] == kw["eos_id"] and len(got) < len(prompt) + 12


def test_main_reads_stdin_through_the_tokenizer(monkeypatch, capsys):
    tok_dir = os.path.join(REPO, "tests", "fixtures", "tokenizers", "bytefallback")
    from veomni_tpu_torch.models.auto import build_tokenizer

    tok = build_tokenizer(tok_dir)
    fields = dict(QWEN3, vocab_size=len(tok))
    monkeypatch.setattr("sys.stdin", io.StringIO("hello there\n\nthe engine serves\n"))
    infer_text.main(["--model.config_overrides=" + json.dumps(fields),
                     f"--model.tokenizer_path={tok_dir}", "--train.platform=cpu"])
    out = capsys.readouterr().out
    model = Transformer(TransformerConfig(**fields), torch.Generator().manual_seed(0),
                        device="cpu")
    want = ["enter prompt (ctrl-d to exit):"] + [
        tok.decode(infer_text.generate(model, model.cfg, tok(prompt)["input_ids"],
                                       eos_id=tok.eos_token_id))
        for prompt in ("hello there", "the engine serves")]
    assert out == "".join(line + "\n" for line in want)

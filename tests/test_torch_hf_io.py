"""The port's HF weight I/O (``veomni_tpu_torch/models/hf_io.py``) and config
round-trip against the JAX package's, on the CPU, at toy sizes.

* The port's own safetensors reader and writer: files it writes are read
  equal by the ``safetensors`` package (installed here, not on the card's
  machine), and files the package writes are read equal by the port, for
  BF16, F16, F32, I64 and I32.
* Files written by the JAX ``save_hf_checkpoint`` (single-file and sharded,
  with ``model.safetensors.index.json``) load in the port to exactly what
  the JAX ``hf_to_params`` gives, for llama, qwen3 and qwen3_moe toys; and
  the port's export reads back in the JAX ``hf_to_params`` to exactly the
  port's parameters, under the same file names and index.
* ``TransformerConfig.from_hf_config`` / ``to_hf_config`` give the JAX
  dataclass's fields for the families' published configs.
Weights are f32 (the reference exports its master parameters), so every
comparison is exact.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from veomni_tpu.models import hf_io as j_hf_io
from veomni_tpu.models.config import TransformerConfig as JaxConfig
from veomni_tpu.models.transformer import init_params as j_init
from veomni_tpu_torch.models import hf_io
from veomni_tpu_torch.models.auto import build_foundation_model
from veomni_tpu_torch.models.config import TransformerConfig
from veomni_tpu_torch.models.jax_weights import to_jax_tree
from veomni_tpu_torch.models.transformer import Transformer
from test_torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)

TOYS = {
    "llama": dict(model_type="llama", vocab_size=96, hidden_size=64, intermediate_size=96,
                  num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                  head_dim=16),
    "qwen3": dict(model_type="qwen3", vocab_size=96, hidden_size=64, intermediate_size=96,
                  num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                  head_dim=16, qk_norm=True, tie_word_embeddings=True),
    "qwen3_moe": dict(model_type="qwen3_moe", vocab_size=96, hidden_size=64,
                      intermediate_size=96, num_hidden_layers=2, num_attention_heads=4,
                      num_key_value_heads=2, head_dim=16, qk_norm=True, num_experts=4,
                      num_experts_per_tok=2, moe_intermediate_size=32),
}
# single file, or shards of at most this many bytes (several per model)
SHARDING = {"single": 4 * 1024**3, "sharded": 60_000}


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _assert_trees_equal(got, ref):
    got, ref = _leaves(got), _leaves(ref)
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k].shape == ref[k].shape, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def _written(out_dir):
    """(file names, the index's weight map or None)."""
    index = os.path.join(out_dir, hf_io.INDEX_NAME)
    weight_map = None
    if os.path.exists(index):
        with open(index) as f:
            weight_map = json.load(f)["weight_map"]
    return sorted(os.listdir(out_dir)), weight_map


@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32", "int64", "int32"])
def test_safetensors_files_match_the_package(tmp_path, dtype):
    from safetensors.torch import load_file as st_load
    from safetensors.torch import save_file as st_save

    rng = np.random.default_rng(0)
    tensors = {}
    for i, shape in enumerate(((3, 5), (7,), (2, 3, 4), (0, 4), (1, 1))):
        x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * 100)
        tensors[f"t{i}.weight"] = x.to(getattr(torch, dtype))
    ours = str(tmp_path / "ours.safetensors")
    hf_io.save_file(tensors, ours)
    back = st_load(ours)
    theirs = str(tmp_path / "theirs.safetensors")
    st_save(tensors, theirs)
    for name, x in tensors.items():
        assert back[name].dtype == x.dtype and torch.equal(back[name], x), name
    for name, x in hf_io.load_file(theirs).items():
        assert x.dtype == tensors[name].dtype and torch.equal(x, tensors[name]), name


@pytest.mark.parametrize("sharding", list(SHARDING))
@pytest.mark.parametrize("family", list(TOYS))
def test_jax_export_loads_as_jax_hf_to_params(tmp_path, family, sharding):
    """JAX save_hf_checkpoint -> the port's load (config.json through
    from_hf_config, weights through hf_to_params) == the JAX hf_to_params."""
    j_cfg = JaxConfig(**TOYS[family])
    out = str(tmp_path / "hf")
    j_hf_io.save_hf_checkpoint(j_init(jax.random.PRNGKey(1), j_cfg), j_cfg, out,
                               max_shard_bytes=SHARDING[sharding])
    _, weight_map = _written(out)
    assert (weight_map is not None) == (sharding == "sharded")
    ref = j_hf_io.hf_to_params(out, j_cfg)
    fm = build_foundation_model(out, weights_path=out, device="cpu", dtype="float32")
    _assert_trees_equal(to_jax_tree(fm.module), ref)


@pytest.mark.parametrize("sharding", list(SHARDING))
@pytest.mark.parametrize("family", list(TOYS))
def test_port_export_reads_back_in_jax(tmp_path, family, sharding):
    """The port's save_hf_checkpoint -> the JAX hf_to_params == the port's
    parameters; the same file names, index and tensor names as the JAX
    export of the same weights."""
    cfg = TransformerConfig(**TOYS[family])
    model = Transformer(cfg, torch.Generator().manual_seed(2), device="cpu")
    ours, theirs = str(tmp_path / "ours"), str(tmp_path / "theirs")
    hf_io.save_hf_checkpoint(model, cfg, ours, max_shard_bytes=SHARDING[sharding])
    j_cfg = JaxConfig.from_pretrained(ours)
    back = j_hf_io.hf_to_params(ours, j_cfg)
    _assert_trees_equal(back, to_jax_tree(model))
    j_hf_io.save_hf_checkpoint(back, j_cfg, theirs, max_shard_bytes=SHARDING[sharding])
    assert _written(ours) == _written(theirs)
    with open(os.path.join(ours, "config.json")) as f, \
            open(os.path.join(theirs, "config.json")) as g:
        assert json.load(f) == json.load(g)
    # and the port's own reader of its own files
    again = Transformer(cfg, None, device="cpu")
    hf_io.hf_to_params(ours, cfg, again)
    for (name, a), (_, b) in zip(again.named_parameters(), model.named_parameters()):
        assert torch.equal(a, b), name


def test_missing_tensor_raises_and_untied_head_falls_back(tmp_path):
    cfg = TransformerConfig(**TOYS["llama"])
    model = Transformer(cfg, torch.Generator().manual_seed(3), device="cpu")
    tensors = hf_io.params_to_hf(model, cfg)
    del tensors["lm_head.weight"]  # untied head missing: the embedding transposed
    loaded = hf_io.hf_to_params(None, cfg, Transformer(cfg, None, device="cpu"), tensors=tensors)
    assert torch.equal(loaded.lm_head, model.embed_tokens.t())
    del tensors["model.layers.1.self_attn.k_proj.weight"]
    with pytest.raises(KeyError, match="layers.1.self_attn.k_proj.weight"):
        hf_io.hf_to_params(None, cfg, Transformer(cfg, None, device="cpu"), tensors=tensors)


def test_lazy_reader_reads_nothing_until_asked(tmp_path, monkeypatch):
    """Opening a checkpoint parses headers only; a load reads each tensor
    once, so the host never holds the model twice."""
    cfg = TransformerConfig(**TOYS["qwen3_moe"])
    model = Transformer(cfg, torch.Generator().manual_seed(4), device="cpu")
    hf_io.save_hf_checkpoint(model, cfg, str(tmp_path), max_shard_bytes=60_000)
    reads = []
    real = hf_io.SafetensorsFile.get_tensor
    monkeypatch.setattr(hf_io.SafetensorsFile, "get_tensor",
                        lambda self, name: reads.append(name) or real(self, name))
    lazy = hf_io.LazyHFTensors(str(tmp_path))
    assert not reads and len(lazy.keys()) == len(hf_io.params_to_hf(model, cfg))
    hf_io.hf_to_params(str(tmp_path), cfg, Transformer(cfg, None, device="cpu"))
    assert sorted(reads) == sorted(lazy.keys())


# the published configs of the families (key subsets), and dialects whose
# features the port's model does not build (mapped all the same)
HF_CONFIGS = {
    # huggingface.co/TinyLlama/TinyLlama-1.1B-intermediate-step-1431k-3T/config.json
    "tinyllama": dict(model_type="llama", hidden_size=2048, intermediate_size=5632,
                      num_hidden_layers=22, num_attention_heads=32, num_key_value_heads=4,
                      vocab_size=32000, rms_norm_eps=1e-5, rope_theta=10000.0,
                      max_position_embeddings=2048, tie_word_embeddings=False,
                      hidden_act="silu", attention_bias=False, rope_scaling=None),
    "qwen3": dict(model_type="qwen3", hidden_size=1024, intermediate_size=3072,
                  num_hidden_layers=28, num_attention_heads=16, num_key_value_heads=8,
                  head_dim=128, vocab_size=151936, rms_norm_eps=1e-6, rope_theta=1e6,
                  tie_word_embeddings=True, use_sliding_window=False, sliding_window=None),
    "qwen3_moe": dict(model_type="qwen3_moe", hidden_size=2048, intermediate_size=6144,
                      num_hidden_layers=48, num_attention_heads=32, num_key_value_heads=4,
                      head_dim=128, vocab_size=151936, num_experts=128,
                      num_experts_per_tok=8, moe_intermediate_size=768, norm_topk_prob=True),
    "llama3-rope": dict(model_type="llama", hidden_size=64, num_attention_heads=4,
                        rope_scaling={"rope_type": "llama3", "factor": 8.0}),
    "qwen2-bias": dict(model_type="qwen2", hidden_size=64, num_attention_heads=4),
    "gemma3": dict(model_type="gemma3_text", hidden_size=64, num_attention_heads=4,
                   head_dim=16, query_pre_attn_scalar=16, final_logit_softcapping=30.0),
    "deepseek_v3": dict(model_type="deepseek_v3", hidden_size=64, num_attention_heads=4,
                        n_routed_experts=8, kv_lora_rank=16, q_lora_rank=24),
}


def _fields(cfg):
    return {k: v for k, v in dataclasses.asdict(cfg).items()
            if k not in ("dtype", "param_dtype")}


@pytest.mark.parametrize("name", list(HF_CONFIGS))
def test_config_round_trip_matches_jax(name):
    hf = HF_CONFIGS[name]
    got, ref = TransformerConfig.from_hf_config(hf), JaxConfig.from_hf_config(hf)
    assert _fields(got) == _fields(ref)
    assert got.to_hf_config() == ref.to_hf_config()
    again = TransformerConfig.from_hf_config(json.loads(json.dumps(got.to_hf_config())))
    assert _fields(again) == _fields(JaxConfig.from_hf_config(ref.to_hf_config()))

"""HF directories and published configs of the dense dialects: the port's
``models/hf_io.py`` and ``TransformerConfig`` against the JAX package's, on
the CPU.

* An HF directory of each dialect (``llama31``, ``qwen2``, ``gemma3`` at
  ``tests/test_hf_parity.py``'s DIMS), written here by ``transformers``
  from a tiny model with its biases and norm weights moved off their
  init, loads into the port equal to the JAX package's load, bit for bit
  (f32); the port's export of it reloads bit-equal.
* The published config.json of Gemma-3-1B, Llama-3.2-1B and Qwen2.5-1.5B
  (``train_text_step.HF_CONFIGS``) map to the JAX dataclass's fields, and
  ``to_hf_config`` -> ``from_hf_config`` keeps ``layer_types``,
  ``rope_local_base_freq``, ``query_pre_attn_scalar``, ``rope_scaling`` and
  ``attention_bias``; Gemma-3-1B's full-attention layers are 5, 11, 17, 23.
"""

import jax
import numpy as np
import pytest
import torch

from veomni_tpu.models import TransformerConfig as JaxConfig
from veomni_tpu.models import hf_io as j_hf_io
from veomni_tpu_torch.models import TransformerConfig
from veomni_tpu_torch.models import hf_io
from veomni_tpu_torch.models.jax_weights import to_jax_tree

from test_torch_dialects import DIALECTS, DIMS
from test_torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)


def _hf_dir(tmp_path, dialect):
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    if dialect == "llama31":
        cfg = transformers.LlamaConfig(**DIMS, tie_word_embeddings=False,
                                       rope_theta=500000.0,
                                       rope_scaling=DIALECTS["llama31"]["rope_scaling"])
        m = transformers.LlamaForCausalLM(cfg)
    elif dialect == "qwen2":
        cfg = transformers.Qwen2Config(**DIMS, tie_word_embeddings=False)
        m = transformers.Qwen2ForCausalLM(cfg)
    else:
        cfg = transformers.Gemma3TextConfig(
            **DIMS, head_dim=16, query_pre_attn_scalar=16, sliding_window=16,
            rope_local_base_freq=10000.0, rope_theta=1000000.0,
            layer_types=DIALECTS["gemma3"]["layer_types"])
        m = transformers.Gemma3ForCausalLM(cfg)
    with torch.no_grad():  # biases and norm weights away from their init
        for name, p in m.named_parameters():
            if name.endswith("bias") or "norm" in name:
                p.add_(torch.randn(p.shape) * 0.1)
    out = str(tmp_path / dialect)
    m.save_pretrained(out, safe_serialization=True)
    return out


@pytest.mark.parametrize("dialect", list(DIALECTS))
def test_hf_directory_loads_as_jax_and_round_trips(tmp_path, dialect):
    from veomni_tpu_torch.models.auto import build_foundation_model

    src = _hf_dir(tmp_path, dialect)
    j_cfg = JaxConfig.from_pretrained(src)
    ref = j_hf_io.hf_to_params(src, j_cfg)
    fm = build_foundation_model(src, weights_path=src, device="cpu", dtype="float32")
    got = to_jax_tree(fm.module)
    ref_leaves = {jax.tree_util.keystr(p): np.asarray(v)
                  for p, v in jax.tree_util.tree_leaves_with_path(ref)}
    got_leaves = {jax.tree_util.keystr(p): v
                  for p, v in jax.tree_util.tree_leaves_with_path(got)}
    assert got_leaves.keys() == ref_leaves.keys()
    for key, value in ref_leaves.items():
        np.testing.assert_array_equal(got_leaves[key], value, err_msg=key)
    if dialect == "gemma3":
        assert fm.config.sandwich_norms and fm.config.embed_scale == 64 ** 0.5
        assert [fm.config.window_for_layer(i) for i in range(3)] == [16, 16, 0]
    if dialect == "qwen2":
        assert "['layers']['q_bias']" in got_leaves and fm.config.attention_bias
    out = str(tmp_path / "export")
    hf_io.save_hf_checkpoint(fm.module, fm.config, out)
    again = build_foundation_model(out, weights_path=out, device="cpu", dtype="float32")
    for (name, a), (_, b) in zip(again.module.named_parameters(), fm.module.named_parameters()):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("preset", ["gemma3_1b", "llama3p2_1b", "qwen2p5_1p5b"])
def test_published_configs_round_trip_as_jax(preset):
    """The presets' config.json map to the JAX dataclass's fields, and
    ``to_hf_config`` -> ``from_hf_config`` keeps the dialect's fields."""
    import dataclasses

    from veomni_tpu_torch.models.transformer import check_supported
    from veomni_tpu_torch.train_text_step import HF_CONFIGS

    def fields(cfg):
        return {k: v for k, v in dataclasses.asdict(cfg).items()
                if k not in ("dtype", "param_dtype")}

    hf = HF_CONFIGS[preset]
    got, ref = TransformerConfig.from_hf_config(hf), JaxConfig.from_hf_config(hf)
    assert fields(got) == fields(ref)
    assert got.to_hf_config() == ref.to_hf_config()
    again = TransformerConfig.from_hf_config(got.to_hf_config())
    for key in ("layer_types", "rope_local_base_freq", "query_pre_attn_scalar", "rope_scaling",
                "attention_bias", "sliding_window", "embed_scale", "hidden_act"):
        assert getattr(again, key) == getattr(got, key), key
    check_supported(got)
    windows = [got.window_for_layer(i) for i in range(got.num_hidden_layers)]
    if preset == "gemma3_1b":
        assert [i for i, w in enumerate(windows) if w == 0] == [5, 11, 17, 23]
        assert set(windows) == {0, 512} and got.embed_scale == 1152 ** 0.5
    else:
        assert set(windows) == {0}

"""HF directories and published configs of the deepseek dialect: the port's
``models/hf_io.py`` and ``TransformerConfig`` against the JAX package's, and
the port's model against HF transformers' deepseek, on the CPU.

* An HF directory of a deepseek_v3 toy (q low-rank pair, sigmoid routing in
  2 groups, a shared expert, a leading dense layer) and of a deepseek_v2
  toy (no q low-rank pair, softmax greedy routing), written here by
  ``transformers`` with the norm weights and the correction biases moved
  off their init: the MLA keys, ``mlp.gate.e_score_correction_bias``, the
  ``mlp.shared_experts.*`` keys and the dense-then-MoE layer numbering load
  into the port equal to the JAX package's load (its ``dense_layers`` and
  ``layers`` subtrees), bit for bit (f32); the port's export reloads
  bit-equal in the port and in the JAX package.
* The same models' loss through the port equals transformers' own (f32,
  rtol 1e-5), at an init scale (std 0.3) where the rope moves the loss.
  The reference's MLA rope pairs the interleaved rotation with the
  concatenated-halves tables, and at this scale its loss is 3.7% off
  (ROADMAP.md queue 3). transformers' native deepseek_v2 leaves the yarn
  mscale out of the softmax scale, where the reference (and DeepSeek's own
  modeling code) applies it, so that toy runs without yarn here.
* The published config.json of Moonlight-16B-A3B and DeepSeek-V2-Lite
  (``train_text_step.HF_CONFIGS``) map to the JAX dataclass's fields,
  ``to_hf_config`` -> ``from_hf_config`` keeps the dialect's fields, and
  ``bench_config`` builds the same config as a train-step preset.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from veomni_tpu.models import TransformerConfig as JaxConfig
from veomni_tpu.models import hf_io as j_hf_io
from veomni_tpu_torch.models import TransformerConfig
from veomni_tpu_torch.models import hf_io
from veomni_tpu_torch.models.auto import build_foundation_model
from veomni_tpu_torch.models.jax_weights import to_jax_tree
from veomni_tpu_torch.models.transformer import check_supported
from veomni_tpu_torch.train_text_step import HF_CONFIGS, bench_config
from test_torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)

DIMS = dict(vocab_size=257, hidden_size=64, intermediate_size=112, num_hidden_layers=3,
            num_attention_heads=4, num_key_value_heads=4, max_position_embeddings=256,
            tie_word_embeddings=False, kv_lora_rank=16, qk_nope_head_dim=16,
            qk_rope_head_dim=8, v_head_dim=16, n_routed_experts=8, num_experts_per_tok=2,
            moe_intermediate_size=32, n_shared_experts=1, first_k_dense_replace=1)


def _hf_dir(tmp_path, kind, init_std=0.02):
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    if kind == "deepseek_v3":
        cfg = transformers.DeepseekV3Config(**DIMS, q_lora_rank=24, n_group=2, topk_group=1,
                                            routed_scaling_factor=1.5, norm_topk_prob=True,
                                            initializer_range=init_std)
        m = transformers.DeepseekV3ForCausalLM(cfg)
    else:
        cfg = transformers.DeepseekV2Config(**DIMS, q_lora_rank=None, topk_method="greedy",
                                            norm_topk_prob=False, routed_scaling_factor=1.0,
                                            aux_loss_alpha=0.0, initializer_range=init_std)
        m = transformers.DeepseekV2ForCausalLM(cfg)
    with torch.no_grad():  # norm weights and correction biases away from their init
        for name, p in [*m.named_parameters(), *m.named_buffers()]:
            if "norm" in name or "e_score_correction_bias" in name:
                p.add_(torch.randn(p.shape) * 0.1)
    out = str(tmp_path / kind)
    m.save_pretrained(out, safe_serialization=True)
    return m.eval(), out


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("kind", ["deepseek_v3", "deepseek_v2"])
def test_hf_directory_loads_as_jax_and_round_trips(tmp_path, kind):
    _, src = _hf_dir(tmp_path, kind)
    ref = _leaves(j_hf_io.hf_to_params(src, JaxConfig.from_pretrained(src)))
    fm = build_foundation_model(src, weights_path=src, device="cpu", dtype="float32")
    got = _leaves(to_jax_tree(fm.module))
    assert got.keys() == ref.keys()
    for key, value in ref.items():
        np.testing.assert_array_equal(got[key], value, err_msg=key)
    assert "['dense_layers']['gate_proj']" in got
    assert "['layers']['shared_experts']['up_proj']" in got
    if kind == "deepseek_v3":
        bias = got["['layers']['e_score_correction_bias']"]
        assert bias.shape == (2, 8) and np.abs(bias).max() > 0
        assert "['layers']['q_a_proj']" in got
    else:
        assert "['layers']['q_proj']" in got
    out = str(tmp_path / "export")
    hf_io.save_hf_checkpoint(fm.module, fm.config, out)
    again = build_foundation_model(out, weights_path=out, device="cpu", dtype="float32")
    for (name, a), (_, b) in zip(again.module.named_parameters(), fm.module.named_parameters()):
        assert torch.equal(a, b), name
    back = _leaves(j_hf_io.hf_to_params(out, JaxConfig.from_pretrained(out)))
    assert back.keys() == ref.keys()
    for key, value in ref.items():
        np.testing.assert_array_equal(back[key], value, err_msg=key)


@pytest.mark.parametrize("kind", ["deepseek_v3", "deepseek_v2"])
def test_loss_matches_transformers(tmp_path, kind):
    hf_model, src = _hf_dir(tmp_path, kind, init_std=0.3)
    ids = np.random.default_rng(0).integers(0, DIMS["vocab_size"], (2, 48))
    with torch.no_grad():
        want = float(hf_model(input_ids=torch.tensor(ids), labels=torch.tensor(ids)).loss)
    fm = build_foundation_model(src, weights_path=src, device="cpu", dtype="float32",
                                router_aux_loss_coef=0.0)
    b, s = ids.shape
    batch = {"input_ids": torch.tensor(ids),
             "labels": torch.tensor(np.concatenate([ids[:, 1:], np.full((b, 1), -100)], 1)),
             "position_ids": torch.arange(s).expand(b, s),
             "segment_ids": torch.ones((b, s), dtype=torch.int32)}
    with torch.no_grad():
        loss_sum, metrics = fm.module.loss_fn(batch)
    np.testing.assert_allclose(loss_sum.item() / metrics["ntokens"].item(), want, rtol=1e-5)


@pytest.mark.parametrize("preset", ["moonlight_16b_a3b", "deepseek_v2_lite"])
def test_published_configs_round_trip_as_jax(preset):
    def fields(cfg):
        return {k: v for k, v in dataclasses.asdict(cfg).items()
                if k not in ("dtype", "param_dtype")}

    hf = HF_CONFIGS[preset]
    got, ref = TransformerConfig.from_hf_config(hf), JaxConfig.from_hf_config(hf)
    assert fields(got) == fields(ref)
    assert got.to_hf_config() == ref.to_hf_config()
    assert got.to_hf_config()["n_routed_experts"] == 64
    again = TransformerConfig.from_hf_config(got.to_hf_config())
    assert fields(again) == fields(got)
    check_supported(got)
    assert got.use_mla and got.qk_head_dim == 192 and got.v_head_dim == 128
    # the same file as a train_text_step preset: f32 master, bf16 compute, ctx remat
    bench = bench_config(preset, num_hidden_layers=4)
    assert fields(bench) == {**fields(got), "num_hidden_layers": 4, "remat_policy": "ctx"}
    assert (bench.dtype, bench.param_dtype) == (torch.bfloat16, torch.float32)
    assert got.first_k_dense_replace == 1 and got.n_shared_experts == 2
    assert got.q_lora_rank == 0 and got.router_aux_loss_coef == 0.001
    if preset == "moonlight_16b_a3b":
        assert (got.scoring_func, got.norm_topk_prob, got.routed_scaling_factor) == (
            "sigmoid", True, 2.446)
    else:
        assert (got.scoring_func, got.norm_topk_prob, got.routed_scaling_factor) == (
            "softmax", False, 1.0)
        assert got.rope_scaling["mscale_all_dim"] == 0.707

"""HF directories and the published config of the gpt_oss dialect: the
port's ``models/hf_io.py`` and ``TransformerConfig`` against the JAX
package's, and the port's model against HF transformers' gpt_oss, on the
CPU.

* An HF directory of ``tests/test_hf_parity.py``'s gpt_oss toy (4 experts
  at top-2, a 16-token window on layers 0 and 2), written by
  ``transformers`` with the sinks and every bias moved off their init: the
  fused interleaved experts (``mlp.experts.gate_up_proj`` [E, H, 2I], gate
  in the even columns), their biases, ``mlp.router.*`` and
  ``self_attn.sinks`` load into the port equal to the JAX package's load,
  bit for bit (f32). Both ways across the packages: the port's export
  reads back equal in the JAX package and in the port, and the JAX
  package's export reads equal in the port.
* The same model's loss through the port equals transformers' own (f32,
  rtol 1e-5). GptOssConfig's default rope is yarn with ``truncate`` false,
  which the port follows (ROADMAP.md queue 3).
* The published config.json of gpt-oss-20b (``train_text_step.HF_CONFIGS``)
  maps to the JAX dataclass's fields, ``to_hf_config`` -> ``from_hf_config``
  keeps the dialect's fields, and ``bench_config`` builds the same config.
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

# tests/test_hf_parity.py's DIMS and gpt_oss toy
DIMS = dict(vocab_size=257, hidden_size=64, intermediate_size=112, num_hidden_layers=3,
            num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=256,
            tie_word_embeddings=False)


def _hf_dir(tmp_path, init_std=0.02):
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    cfg = transformers.GptOssConfig(
        **DIMS, head_dim=16, num_local_experts=4, num_experts_per_tok=2, sliding_window=16,
        layer_types=["sliding_attention", "full_attention", "sliding_attention"],
        router_aux_loss_coef=0.0, output_router_logits=False, initializer_range=init_std)
    m = transformers.GptOssForCausalLM(cfg)
    with torch.no_grad():  # sinks, biases and norms away from their init
        for name, p in m.named_parameters():
            if name.endswith("sinks"):
                p.copy_(torch.randn(p.shape))
            elif "bias" in name or "norm" in name:
                p.add_(torch.randn(p.shape) * 0.1)
    out = str(tmp_path / "gpt_oss")
    m.save_pretrained(out, safe_serialization=True)
    return m.eval(), out


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _assert_equal_trees(got, ref):
    assert got.keys() == ref.keys()
    for key, value in ref.items():
        np.testing.assert_array_equal(got[key], value, err_msg=key)


def test_fused_layout_loads_as_jax_and_round_trips(tmp_path):
    _, src = _hf_dir(tmp_path)
    keys = set(hf_io.LazyHFTensors(src).keys())
    assert {"model.layers.0.mlp.experts.gate_up_proj", "model.layers.0.mlp.router.bias",
            "model.layers.0.mlp.experts.gate_up_proj_bias",
            "model.layers.0.self_attn.sinks"} <= keys
    jcfg = JaxConfig.from_pretrained(src)
    ref = _leaves(j_hf_io.hf_to_params(src, jcfg))
    fm = build_foundation_model(src, weights_path=src, device="cpu", dtype="float32")
    got = _leaves(to_jax_tree(fm.module))
    _assert_equal_trees(got, ref)
    for leaf in ("['sinks']", "['router_bias']", "['experts']['gate_bias']",
                 "['experts']['up_bias']", "['experts']['down_bias']"):
        assert np.abs(got["['layers']" + leaf]).max() > 0, leaf
    gate, up = got["['layers']['experts']['gate_proj']"], got["['layers']['experts']['up_proj']"]
    assert gate.shape == up.shape == (3, 4, 64, 112) and not np.array_equal(gate, up)

    # the port writes: the JAX package and the port read it back equal
    out = str(tmp_path / "port_export")
    hf_io.save_hf_checkpoint(fm.module, fm.config, out)
    assert set(hf_io.LazyHFTensors(out).keys()) == keys
    _assert_equal_trees(_leaves(j_hf_io.hf_to_params(out, JaxConfig.from_pretrained(out))), ref)
    again = build_foundation_model(out, weights_path=out, device="cpu", dtype="float32")
    for (name, a), (_, b) in zip(again.module.named_parameters(), fm.module.named_parameters()):
        assert torch.equal(a, b), name

    # the JAX package writes: the port reads it equal
    jout = str(tmp_path / "jax_export")
    j_hf_io.save_hf_checkpoint(j_hf_io.hf_to_params(src, jcfg), jcfg, jout)
    back = build_foundation_model(jout, weights_path=jout, device="cpu", dtype="float32")
    _assert_equal_trees(_leaves(to_jax_tree(back.module)), ref)


def test_loss_matches_transformers(tmp_path):
    hf_model, src = _hf_dir(tmp_path, init_std=0.1)
    ids = np.random.default_rng(0).integers(0, DIMS["vocab_size"], (2, 48))
    with torch.no_grad():
        want = float(hf_model(input_ids=torch.tensor(ids), labels=torch.tensor(ids)).loss)
    fm = build_foundation_model(src, weights_path=src, device="cpu", dtype="float32")
    assert fm.config.rope_scaling["truncate"] is False
    b, s = ids.shape
    batch = {"input_ids": torch.tensor(ids),
             "labels": torch.tensor(np.concatenate([ids[:, 1:], np.full((b, 1), -100)], 1)),
             "position_ids": torch.arange(s).expand(b, s),
             "segment_ids": torch.ones((b, s), dtype=torch.int32)}
    with torch.no_grad():
        loss_sum, metrics = fm.module.loss_fn(batch)
    np.testing.assert_allclose(loss_sum.item() / metrics["ntokens"].item(), want, rtol=1e-5)


def test_published_config_round_trips_as_jax():
    def fields(cfg):
        return {k: v for k, v in dataclasses.asdict(cfg).items()
                if k not in ("dtype", "param_dtype")}

    hf = HF_CONFIGS["gpt_oss_20b"]
    got, ref = TransformerConfig.from_hf_config(hf), JaxConfig.from_hf_config(hf)
    assert fields(got) == fields(ref)
    assert got.to_hf_config() == ref.to_hf_config()
    assert got.to_hf_config()["num_local_experts"] == 32
    again = TransformerConfig.from_hf_config(got.to_hf_config())
    assert fields(again) == fields(got)
    check_supported(got)
    assert (got.hidden_act, got.num_experts, got.num_experts_per_tok) == ("gpt_oss_glu", 32, 4)
    assert got.attention_sinks and got.router_bias and got.mlp_bias and got.o_bias
    assert [got.window_for_layer(i) for i in range(4)] == [128, 0, 128, 0]
    assert got.router_aux_loss_coef == 0.9 and got.rope_scaling["truncate"] is False
    bench = bench_config("gpt_oss_20b", num_hidden_layers=3)
    assert fields(bench) == {**fields(got), "num_hidden_layers": 3, "remat_policy": "ctx"}
    assert (bench.dtype, bench.param_dtype) == (torch.bfloat16, torch.float32)


def test_serve_cli_serves_the_hf_directory(tmp_path):
    """``tasks/serve.py --model-path`` serves the HF directory in bf16: each
    request's tokens equal ``greedy_generate`` on the same directory's
    model."""
    from veomni_tpu_torch.models import decode as tdec
    from veomni_tpu_torch.tasks import serve

    _, src = _hf_dir(tmp_path)
    prompts = [[5, 17, 3, 99, 42, 7, 8, 250, 11], [1, 2, 3]]
    outs = serve.main(["--device", "cpu", "--model-path", src, "--max-new", "4",
                       "--prefill-chunk", "8", *(a for p in prompts
                                                 for a in ("--prompt-ids", ",".join(map(str, p))))])
    fm = build_foundation_model(src, weights_path=src, device="cpu", param_dtype="bfloat16")
    for rid, p in zip(sorted(outs), prompts):
        want = tdec.greedy_generate(fm.module, fm.config, p, max_new_tokens=4)[len(p):]
        assert outs[rid].token_ids == want, rid

"""Text SFT train steps on packed synthetic data (the port's main paths).

Port of the train leg of ``bench.py::run_bench`` (``bench.py:313``): build
the model config (the ``bench.py`` presets, ``:158-197``, plus the MoE
model the repo ships a recipe for, ``configs/text/qwen3_moe_ep.yaml``), the
model, AdamW with the bench's cosine schedule, the train state and the train
step, then run N steps over packed batches. The batches come from seeded
synthetic documents packed by ``TextPackingCollator`` (several documents per
row, so attention runs with real segment ids). The YAML trainer is a later
slice.

Run on the card (the dense Qwen3-0.6B step; the Qwen3-30B-A3B MoE step,
depth cut to 4 layers to fit one H100)::

    python -m veomni_tpu_torch.train_text_step --steps 3 --seq-len 4096 --micro-bs 4
    python -m veomni_tpu_torch.train_text_step --preset qwen3_30b_a3b --num-layers 4

A preset may also name a published HF config of ``HF_CONFIGS`` (e.g.
``--preset moonlight_16b_a3b --num-layers 4 --micro-bs 2``: its leading
dense layer and three MoE layers; ``--preset gpt_oss_20b --num-layers 3
--micro-bs 2``: a sliding, a full and a sliding layer of gpt-oss-20b).
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from veomni_tpu_torch.data import TextPackingCollator, stack_micro_batches
from veomni_tpu_torch.models import Transformer, TransformerConfig
from veomni_tpu_torch.ops.kernel_registry import apply_ops_config
from veomni_tpu_torch.optim import build_lr_scheduler, build_optimizer
from veomni_tpu_torch.train import build_train_state, build_train_step
from veomni_tpu_torch.utils.count_flops import FlopsCounter
from veomni_tpu_torch.utils.device import DeviceLike, get_device_peak_flops, resolve_device, synchronize

SEED = 0  # model init and synthetic data
# Qwen3-30B-A3B, the published Qwen/Qwen3-30B-A3B config.json: 48 layers of
# 32/4-head GQA attention (head_dim 128, qk-norm) and 128 experts, top-8,
# expert width 768 (intermediate_size 6144 is the unused dense width).
_QWEN3_30B_A3B = dict(
    model_type="qwen3_moe", hidden_size=2048, intermediate_size=6144, num_hidden_layers=48,
    num_attention_heads=32, num_key_value_heads=4, tie_word_embeddings=False,
    max_position_embeddings=40960, rms_norm_eps=1e-6, num_experts=128,
    num_experts_per_tok=8, moe_intermediate_size=768, norm_topk_prob=True,
    router_aux_loss_coef=0.001, param_dtype="float32",
)
# bench.py:158-172; "qwen3_0p6b" is the repo's headline configuration. The
# smoke presets are CPU-sized.
BENCH_PRESETS = {
    "qwen3_0p6b": dict(hidden_size=1024, intermediate_size=3072,
                       num_hidden_layers=28, param_dtype="float32"),
    "qwen3_smoke": dict(hidden_size=256, intermediate_size=512,
                        num_hidden_layers=2, param_dtype="float32"),
    "qwen3_30b_a3b": _QWEN3_30B_A3B,
    "qwen3_moe_smoke": {**_QWEN3_30B_A3B, "hidden_size": 256, "intermediate_size": 512,
                        "num_hidden_layers": 2, "num_attention_heads": 4,
                        "num_key_value_heads": 2, "num_experts": 8,
                        "num_experts_per_tok": 2, "moe_intermediate_size": 128},
}


# Published HF config.json files, kept here as values (no download): a run
# writes one into an HF directory and builds the model from it
# (``TransformerConfig.from_hf_config``). TinyLlama-1.1B is
# huggingface.co/TinyLlama/TinyLlama-1.1B-intermediate-step-1431k-3T/config.json:
# llama, 22 layers, hidden 2048, 32 query / 4 kv heads (head dim 64), SwiGLU
# width 5632, vocab 32000, untied head, rope theta 10000, no rope scaling.
HF_CONFIGS = {
    "tinyllama_1p1b": {
        "architectures": ["LlamaForCausalLM"],
        "attention_bias": False,
        "bos_token_id": 1,
        "eos_token_id": 2,
        "hidden_act": "silu",
        "hidden_size": 2048,
        "initializer_range": 0.02,
        "intermediate_size": 5632,
        "max_position_embeddings": 2048,
        "model_type": "llama",
        "num_attention_heads": 32,
        "num_hidden_layers": 22,
        "num_key_value_heads": 4,
        "pretraining_tp": 1,
        "rms_norm_eps": 1e-05,
        "rope_scaling": None,
        "rope_theta": 10000.0,
        "tie_word_embeddings": False,
        "torch_dtype": "bfloat16",
        "use_cache": True,
        "vocab_size": 32000,
    },
    # huggingface.co/google/gemma-3-1b-pt/config.json, with ``layer_types``
    # written out (five sliding, one full; full at layers 5, 11, 17, 23) as
    # transformers >= 4.53 saves it: the file on the hub names only
    # ``sliding_window_pattern`` 6, which the reference's
    # ``TransformerConfig.window_for_layer`` does not read (it would window
    # every layer; ROADMAP.md queue 3)
    "gemma3_1b": {
        "architectures": ["Gemma3ForCausalLM"],
        "attention_bias": False,
        "attention_dropout": 0.0,
        "attn_logit_softcapping": None,
        "bos_token_id": 2,
        "cache_implementation": "hybrid",
        "eos_token_id": 1,
        "final_logit_softcapping": None,
        "head_dim": 256,
        "hidden_activation": "gelu_pytorch_tanh",
        "hidden_size": 1152,
        "initializer_range": 0.02,
        "intermediate_size": 6912,
        "layer_types": ["full_attention" if (i + 1) % 6 == 0 else "sliding_attention"
                        for i in range(26)],
        "max_position_embeddings": 32768,
        "model_type": "gemma3_text",
        "num_attention_heads": 4,
        "num_hidden_layers": 26,
        "num_key_value_heads": 1,
        "pad_token_id": 0,
        "query_pre_attn_scalar": 256,
        "rms_norm_eps": 1e-06,
        "rope_local_base_freq": 10000,
        "rope_scaling": None,
        "rope_theta": 1000000,
        "sliding_window": 512,
        "sliding_window_pattern": 6,
        "torch_dtype": "bfloat16",
        "use_cache": True,
        "vocab_size": 262144,
    },
    # huggingface.co/meta-llama/Llama-3.2-1B/config.json
    "llama3p2_1b": {
        "architectures": ["LlamaForCausalLM"],
        "attention_bias": False,
        "attention_dropout": 0.0,
        "bos_token_id": 128000,
        "eos_token_id": 128001,
        "head_dim": 64,
        "hidden_act": "silu",
        "hidden_size": 2048,
        "initializer_range": 0.02,
        "intermediate_size": 8192,
        "max_position_embeddings": 131072,
        "mlp_bias": False,
        "model_type": "llama",
        "num_attention_heads": 32,
        "num_hidden_layers": 16,
        "num_key_value_heads": 8,
        "pretraining_tp": 1,
        "rms_norm_eps": 1e-05,
        "rope_scaling": {"factor": 32.0, "high_freq_factor": 4.0, "low_freq_factor": 1.0,
                         "original_max_position_embeddings": 8192, "rope_type": "llama3"},
        "rope_theta": 500000.0,
        "tie_word_embeddings": True,
        "torch_dtype": "bfloat16",
        "use_cache": True,
        "vocab_size": 128256,
    },
    # huggingface.co/Qwen/Qwen2.5-1.5B/config.json (q/k/v biases: the qwen2
    # dialect; its sliding_window is off, use_sliding_window false)
    "qwen2p5_1p5b": {
        "architectures": ["Qwen2ForCausalLM"],
        "attention_dropout": 0.0,
        "bos_token_id": 151643,
        "eos_token_id": 151643,
        "hidden_act": "silu",
        "hidden_size": 1536,
        "initializer_range": 0.02,
        "intermediate_size": 8960,
        "max_position_embeddings": 131072,
        "max_window_layers": 28,
        "model_type": "qwen2",
        "num_attention_heads": 12,
        "num_hidden_layers": 28,
        "num_key_value_heads": 2,
        "rms_norm_eps": 1e-06,
        "rope_theta": 1000000.0,
        "sliding_window": 131072,
        "tie_word_embeddings": True,
        "torch_dtype": "bfloat16",
        "use_cache": True,
        "use_mrope": False,
        "use_sliding_window": False,
        "vocab_size": 151936,
    },
    # huggingface.co/moonshotai/Moonlight-16B-A3B/blob/main/config.json: the
    # deepseek_v3 dialect, 27 layers (the first dense, width 11264; then 64
    # routed experts of width 1408, top-6, sigmoid noaux-tc with one group,
    # 2 shared experts, routed scaling 2.446), MLA with no q low-rank pair
    # (kv_lora_rank 512, q/k head 128 + 64 rope, v head 128, 16 heads)
    "moonlight_16b_a3b": {
        "architectures": ["DeepseekV3ForCausalLM"],
        "attention_bias": False,
        "attention_dropout": 0.0,
        "aux_loss_alpha": 0.001,
        "bos_token_id": 163584,
        "eos_token_id": 163585,
        "first_k_dense_replace": 1,
        "hidden_act": "silu",
        "hidden_size": 2048,
        "initializer_range": 0.02,
        "intermediate_size": 11264,
        "kv_lora_rank": 512,
        "max_position_embeddings": 8192,
        "model_type": "deepseek_v3",
        "moe_intermediate_size": 1408,
        "moe_layer_freq": 1,
        "n_group": 1,
        "n_routed_experts": 64,
        "n_shared_experts": 2,
        "norm_topk_prob": True,
        "num_attention_heads": 16,
        "num_experts_per_tok": 6,
        "num_hidden_layers": 27,
        "num_key_value_heads": 16,
        "num_nextn_predict_layers": 0,
        "q_lora_rank": None,
        "qk_nope_head_dim": 128,
        "qk_rope_head_dim": 64,
        "rms_norm_eps": 1e-05,
        "rope_scaling": None,
        "rope_theta": 50000.0,
        "routed_scaling_factor": 2.446,
        "scoring_func": "sigmoid",
        "seq_aux": True,
        "tie_word_embeddings": False,
        "topk_group": 1,
        "topk_method": "noaux_tc",
        "torch_dtype": "bfloat16",
        "use_cache": True,
        "v_head_dim": 128,
        "vocab_size": 163840,
    },
    # huggingface.co/deepseek-ai/DeepSeek-V2-Lite/blob/main/config.json: the
    # deepseek_v2 dialect at Moonlight's attention and expert widths, with
    # softmax greedy routing (no renorm, scaling 1), dense width 10944 and
    # yarn rope (factor 40, mscale and mscale_all_dim 0.707, theta 10000)
    "deepseek_v2_lite": {
        "architectures": ["DeepseekV2ForCausalLM"],
        "attention_bias": False,
        "attention_dropout": 0.0,
        "aux_loss_alpha": 0.001,
        "bos_token_id": 100000,
        "eos_token_id": 100001,
        "first_k_dense_replace": 1,
        "hidden_act": "silu",
        "hidden_size": 2048,
        "initializer_range": 0.02,
        "intermediate_size": 10944,
        "kv_lora_rank": 512,
        "max_position_embeddings": 163840,
        "model_type": "deepseek_v2",
        "moe_intermediate_size": 1408,
        "moe_layer_freq": 1,
        "n_group": 1,
        "n_routed_experts": 64,
        "n_shared_experts": 2,
        "norm_topk_prob": False,
        "num_attention_heads": 16,
        "num_experts_per_tok": 6,
        "num_hidden_layers": 27,
        "num_key_value_heads": 16,
        "q_lora_rank": None,
        "qk_nope_head_dim": 128,
        "qk_rope_head_dim": 64,
        "rms_norm_eps": 1e-06,
        "rope_scaling": {"beta_fast": 32, "beta_slow": 1, "factor": 40, "mscale": 0.707,
                         "mscale_all_dim": 0.707, "original_max_position_embeddings": 4096,
                         "type": "yarn"},
        "rope_theta": 10000,
        "routed_scaling_factor": 1.0,
        "scoring_func": "softmax",
        "seq_aux": True,
        "tie_word_embeddings": False,
        "topk_group": 1,
        "topk_method": "greedy",
        "torch_dtype": "bfloat16",
        "use_cache": True,
        "v_head_dim": 128,
        "vocab_size": 102400,
    },
    # huggingface.co/openai/gpt-oss-20b/blob/main/config.json: the gpt_oss
    # dialect, 24 layers alternating a 128-token window and full attention
    # from layer 0, hidden 2880, 64/8 heads at head dim 64 with sinks and
    # q/k/v/o biases, 32 experts of width 2880, top-4 (top-k of the biased
    # router logits, then a softmax over the 4), expert biases, the clamped
    # GLU (swiglu_limit 7), yarn rope (factor 32, theta 150000, truncate
    # false), vocab 201088, untied. Its "quantization_config" (the experts
    # stored in MXFP4) is left out: that is a storage format, not the
    # architecture, and the port, like the reference, reads the bf16 fused
    # layout only.
    "gpt_oss_20b": {
        "architectures": ["GptOssForCausalLM"],
        "attention_bias": True,
        "attention_dropout": 0.0,
        "eos_token_id": 200002,
        "experts_per_token": 4,
        "head_dim": 64,
        "hidden_act": "silu",
        "hidden_size": 2880,
        "initial_context_length": 4096,
        "initializer_range": 0.02,
        "intermediate_size": 2880,
        "layer_types": ["sliding_attention" if i % 2 == 0 else "full_attention"
                        for i in range(24)],
        "max_position_embeddings": 131072,
        "model_type": "gpt_oss",
        "num_attention_heads": 64,
        "num_experts_per_tok": 4,
        "num_hidden_layers": 24,
        "num_key_value_heads": 8,
        "num_local_experts": 32,
        "output_router_logits": False,
        "pad_token_id": 199999,
        "rms_norm_eps": 1e-05,
        "rope_scaling": {"beta_fast": 32.0, "beta_slow": 1.0, "factor": 32.0,
                         "original_max_position_embeddings": 4096, "rope_type": "yarn",
                         "truncate": False},
        "rope_theta": 150000,
        "router_aux_loss_coef": 0.9,
        "sliding_window": 128,
        "swiglu_limit": 7.0,
        "tie_word_embeddings": False,
        "torch_dtype": "bfloat16",
        "use_cache": True,
        "vocab_size": 201088,
    },
}


def bench_config(preset: str = "qwen3_0p6b", **overrides) -> TransformerConfig:
    """Qwen3 config of ``bench.py::bench_config`` (``:175-197``) with the
    bench's default ``ctx`` remat (``bench.py:1691``); a preset's fields
    override the dense Qwen3 defaults. A preset of ``HF_CONFIGS`` is its
    published config.json (``from_hf_config``) with f32 master weights,
    bf16 compute and ``ctx`` remat."""
    if preset in HF_CONFIGS:
        return TransformerConfig.from_hf_config(
            HF_CONFIGS[preset], **{"dtype": torch.bfloat16, "param_dtype": torch.float32,
                                   "remat_policy": "ctx", **overrides})
    fields = dict(
        model_type="qwen3",
        vocab_size=151936,
        num_attention_heads=16,
        num_key_value_heads=8,
        head_dim=128,
        qk_norm=True,
        tie_word_embeddings=True,
        max_position_embeddings=131072,
        rope_theta=1e6,
        dtype=torch.bfloat16,
        remat_policy="ctx",
    )
    return TransformerConfig(**{**fields, **BENCH_PRESETS[preset], **overrides})


def packed_batches(vocab_size: int, seq_len: int, micro_bs: int) -> Iterator[Dict[str, np.ndarray]]:
    """Endless [1, micro_bs, seq_len] packed batches (one micro-batch per
    step, as ``run_bench`` feeds them) of seeded synthetic
    documents (lengths uniform in [seq_len/16, seq_len/2]). Each micro-batch
    is offered enough documents to fill it, counting the collator's
    carry-over, so the carry-over stays bounded."""
    rng = np.random.default_rng(SEED)
    collator = TextPackingCollator(seq_len, micro_bs)
    lo, hi = seq_len // 16, seq_len // 2
    per_micro = 2 * micro_bs * seq_len // (lo + hi) + 1
    while True:
        docs = [{"input_ids": rng.integers(0, vocab_size, int(rng.integers(lo, hi + 1)))}
                for _ in range(per_micro - collator.carryover_len())]
        yield stack_micro_batches([collator(docs)])


def iter_train_steps(
    seq_len: int = 4096,
    micro_bs: int = 4,
    *,
    preset: str = "qwen3_0p6b",
    num_layers: Optional[int] = None,
    ops_config: Optional[Dict[str, str]] = None,
    device: DeviceLike = None,
    keep: Optional[Dict[str, object]] = None,
    cfg_overrides: Optional[Dict[str, object]] = None,
    optimizer: str = "adamw",
) -> Iterator[Dict[str, float]]:
    """Build the model and train step as ``run_bench`` does, then yield one
    record per train step (loss, grad_norm, ntokens, step_ok, the loss fn's
    extras such as moe_aux_loss, step_ms, tokens_per_s and, on a card with a
    published peak, mfu) for as long as the caller asks. ``ops_config`` pins
    ops to impls (e.g. ``{"group_gemm": "xla"}`` for the plain version)
    until the generator is closed; ``num_layers`` cuts depth;
    ``cfg_overrides`` sets config fields (``remat_policy``, ``chunk_mbs``,
    ...) on the preset's; ``optimizer`` names one of
    ``optim/optimizer.py::build_optimizer``'s. ``keep``, where given, receives the
    model (``"model"``), the optimizer (``"optimizer"``) and the first batch
    on the device (``"first_batch"``), for the caller to look at after the
    steps."""
    dev = resolve_device(device)
    overrides = dict(cfg_overrides or {})
    if num_layers is not None:
        overrides["num_hidden_layers"] = num_layers
    cfg = bench_config(preset, **overrides)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    model = Transformer(cfg, gen, device=dev)
    opt = build_optimizer(model, optimizer=optimizer,
                          lr=build_lr_scheduler(lr=1e-4, train_steps=1000))  # run_bench's
    state = build_train_state(model, opt)
    step = build_train_step(Transformer.loss_fn)
    tokens = micro_bs * seq_len
    flops = FlopsCounter.from_config(cfg).batch_flops(tokens, seq_len)
    peak = get_device_peak_flops(dev) if dev.type == "cuda" else None
    batches = packed_batches(cfg.vocab_size, seq_len, micro_bs)
    apply_ops_config(ops_config)
    try:
        while True:
            batch = {k: torch.from_numpy(v).to(dev) for k, v in next(batches).items()}
            if keep is not None:
                keep.setdefault("model", model)
                keep.setdefault("optimizer", opt)
                keep.setdefault("first_batch", batch)
            synchronize(dev)
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            synchronize(dev)
            dt = time.perf_counter() - t0
            rec = {k: float(v) for k, v in metrics.items()}
            rec.update(step_ms=dt * 1e3, tokens_per_s=tokens / dt,
                       mfu=flops / dt / peak if peak else None)
            yield rec
    finally:
        apply_ops_config(None)


def run_train_steps(seq_len: int = 4096, micro_bs: int = 4, steps: int = 3,
                    **kwargs) -> List[Dict[str, float]]:
    """``steps`` records of :func:`iter_train_steps` (same keyword options)."""
    it = iter_train_steps(seq_len, micro_bs, **kwargs)
    try:
        return [next(it) for _ in range(steps)]
    finally:
        it.close()


_KERNEL_CATEGORIES = (  # first match wins; names as CUDA reports them
    ("flash attention (K1-K3)", ("flash_",)),
    # zeros and, under deterministic algorithms, the NaN fill of every
    # uninitialized allocation
    ("fills", ("FillFunctor",)),
    ("grouped GEMM (K4-K6)", ("gmm_",)),
    ("f32 GEMM", ("f32f32", "sgemm")),
    ("bf16 GEMM", ("nvjet", "gemm")),
    ("foreach (AdamW, clip)", ("multi_tensor_apply",)),
    ("copies / casts", ("copy", "Cat")),
    ("reductions", ("reduce_kernel",)),
)


def kernel_time_breakdown(trace_path: str) -> Dict[str, float]:
    """Device kernel time (ms) by category from a torch.profiler chrome
    trace, plus the total and the first-to-last kernel span."""
    import gzip

    opener = gzip.open if trace_path.endswith(".gz") else open
    with opener(trace_path, "rt") as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    out: Dict[str, float] = {}
    for e in kernels:
        name = next((c for c, keys in _KERNEL_CATEGORIES if any(k in e["name"] for k in keys)),
                    "other elementwise")
        out[name] = out.get(name, 0.0) + e["dur"] / 1e3
    out["total"] = sum(e["dur"] for e in kernels) / 1e3
    out["span"] = (max(e["ts"] + e["dur"] for e in kernels) - min(e["ts"] for e in kernels)) / 1e3
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--seq-len", type=int, default=4096)
    ap.add_argument("--micro-bs", type=int, default=4)
    ap.add_argument("--preset", default="qwen3_0p6b", choices=sorted({**BENCH_PRESETS,
                                                                      **HF_CONFIGS}))
    ap.add_argument("--num-layers", type=int, default=None, help="cut the preset's depth")
    ap.add_argument("--device", default=None)
    ap.add_argument("--profile", default=None, metavar="TRACE.json",
                    help="after the steps, profile one more step with torch.profiler: "
                         "print device time by kernel, write a chrome trace here")
    args = ap.parse_args(argv)
    if args.profile and torch.device(args.device or "cuda").type != "cuda":
        ap.error("--profile measures the card's kernels: run it on a CUDA device")
    it = iter_train_steps(args.seq_len, args.micro_bs, preset=args.preset,
                          num_layers=args.num_layers, device=args.device)
    for _ in range(args.steps):
        print(json.dumps(next(it)), flush=True)
    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            rec = next(it)
        print(json.dumps({**rec, "profiled": True}), flush=True)
        print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=30), flush=True)
        prof.export_chrome_trace(args.profile)
        print(json.dumps({"device_ms": kernel_time_breakdown(args.profile)}), flush=True)
    it.close()


if __name__ == "__main__":
    main()

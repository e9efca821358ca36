"""Planted faults in the port: do ``chip_smoke.py``'s checks bite?

For each fault in ``FAULTS``, copy ``chip_smoke.py`` and ``veomni_tpu_torch/``
into a fresh directory outside the checkout (under the system temp
directory), apply one edit to the fault's source file in the copy (the
grouped-GEMM kernels K4-K6 in ``csrc/grouped_gemm.cu``, the flash kernels K1-K3
in ``csrc/flash_attention.cu``, the trainer's resume in
``checkpoint/checkpointer.py`` and ``trainer/base.py``, the HF weight load in
``models/hf_io.py``, the serving engine's paged gather, decode rotary, the
rotary tables its steps share with the contiguous prefill, and prefix-cache
match, the deepseek dialect's correction bias, shared experts, MLA rope
and leading dense layer in ``models/transformer.py``, the gpt_oss
dialect's sinks, routing and expert biases there, its clamped GLU in
``ops/swiglu.py`` and its fused expert layout in ``models/hf_io.py``, the
VLM path's head dim 80 in K1-K3, vision rope, mrope sections, window
reverse gather and patch-embed layout, the SFT path's
LoRA merge in ``lora/lora.py``, expert adapters, frozen update in
``optim/optimizer.py`` and llama2 label mask in ``data/chat_template.py``,
and the int8 KV rows' scale axis in ``ops/quantization.py``, the router's
affinity key in ``serving/router.py``, the prefix-cache flush of a weight
swap in ``serving/engine.py``, the offload remat policies' hooks in
``models/transformer.py``, Muon's orthogonalisation in ``optim/muon.py``,
the numerics provenance's layer in ``observability/numerics.py``, the
flash kernels' census report in ``ops/cuda/flash_attention.py`` and the
redispatch after a chaos kill in ``serving/router.py``, and the parallel
layer's FSDP2 gradient sum in ``parallel/parallel_plan.py``, its router
balance loss over the mesh in ``models/transformer.py`` and its all-to-all
piece order in ``parallel/functional.py``) and run the copy's
``chip_smoke.py`` (for a serving fault, its dense serving phase alone:
``--phases serve_dense``; for a deepseek one, its Moonlight phase:
``--phases hf_trainer_moonlight``; for a gpt_oss one, its gpt-oss-20b phase:
``--phases hf_trainer_gpt_oss``; for a VLM one, its Qwen2-VL-2B or
Qwen2.5-VL-3B phase; for an SFT one, its SFT phase; for the int8 one,
``--phases serve_quant``; for the router and publication ones, ``--phases
serve_router``; for the offload and Muon ones, ``--phases remat``; for the
numerics and census ones, ``--phases trainer``; for the chaos one,
``--phases serve_router``; for the parallel ones, ``--phases parallel``). A fault is
caught when that run exits non-zero, prints no
result line and stops at the check named for the fault. Run from the repository root on a
machine with one NVIDIA Hopper card::

    python3 -m veomni_tpu_torch.tools.fault_check [--log-dir DIR] [--only K1,K6]

It prints, for each fault, the edit, the exit code and the failing check's
log line (with its worst error/allowed ratio), then one JSON summary line,
and exits 0 only if every fault was caught. With ``--log-dir`` each run's
full output goes to ``DIR/<fault>.log``. Kernel libraries already built in
the checkout's ``build/kernels/`` are copied along; they are keyed by a hash
of their sources, so the edited source is always built anew.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import subprocess
import sys
import tempfile
from typing import NamedTuple

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
GMM_SOURCE = os.path.join("veomni_tpu_torch", "csrc", "grouped_gemm.cu")
FLASH_SOURCE = os.path.join("veomni_tpu_torch", "csrc", "flash_attention.cu")
CKPT_SOURCE = os.path.join("veomni_tpu_torch", "checkpoint", "checkpointer.py")
TRAINER_SOURCE = os.path.join("veomni_tpu_torch", "trainer", "base.py")
HF_IO_SOURCE = os.path.join("veomni_tpu_torch", "models", "hf_io.py")
PAGED_SOURCE = os.path.join("veomni_tpu_torch", "ops", "paged_attention.py")
DECODE_SOURCE = os.path.join("veomni_tpu_torch", "models", "decode.py")
PREFIX_SOURCE = os.path.join("veomni_tpu_torch", "serving", "prefix_cache.py")
MODEL_SOURCE = os.path.join("veomni_tpu_torch", "models", "transformer.py")
LORA_SOURCE = os.path.join("veomni_tpu_torch", "lora", "lora.py")
OPTIM_SOURCE = os.path.join("veomni_tpu_torch", "optim", "optimizer.py")
TEMPLATE_SOURCE = os.path.join("veomni_tpu_torch", "data", "chat_template.py")
SWIGLU_SOURCE = os.path.join("veomni_tpu_torch", "ops", "swiglu.py")
ROTARY_SOURCE = os.path.join("veomni_tpu_torch", "ops", "rotary.py")
VL_SOURCE = os.path.join("veomni_tpu_torch", "models", "qwen2_5_vl.py")
QUANT_SOURCE = os.path.join("veomni_tpu_torch", "ops", "quantization.py")
ROUTER_SOURCE = os.path.join("veomni_tpu_torch", "serving", "router.py")
ENGINE_SOURCE = os.path.join("veomni_tpu_torch", "serving", "engine.py")
MUON_SOURCE = os.path.join("veomni_tpu_torch", "optim", "muon.py")
NUMERICS_SOURCE = os.path.join("veomni_tpu_torch", "observability", "numerics.py")
FLASH_WRAPPER_SOURCE = os.path.join("veomni_tpu_torch", "ops", "cuda", "flash_attention.py")
PLAN_SOURCE = os.path.join("veomni_tpu_torch", "parallel", "parallel_plan.py")
FUNCTIONAL_SOURCE = os.path.join("veomni_tpu_torch", "parallel", "functional.py")
# the int8 KV rows divided by the absmax reduced over the wrong axis (across
# the kv heads as well as the head dim) while the sidecar keeps each row's own
# scale: every head but the largest dequantizes shrunk
QUANT_AXIS_WHAT = ("quantize_rows divides each row by the scale reduced across the kv heads "
                   "too (a wrong axis); the sidecar keeps the row's own")
QUANT_AXIS_ANCHOR = "    q = torch.round(xf / safe.unsqueeze(axis))\n"
QUANT_AXIS_EDIT = "    q = torch.round(xf / safe.amax(dim=-1, keepdim=True).unsqueeze(axis))\n"
QUANT_GATE_CHECK = "serve quant: gate kv_quant=int8 weight_quant=none at full width:"
QUANT_GATE_FAILURE = "gate kv_quant=int8 weight_quant=none at full width"
# the SFT faults run chip_smoke.py's SFT phases alone; those read the YAML,
# the fixture tokenizers and the docs their chat rows are built from
SFT_DENSE = ("--phases", "sft_lora_dense")
SFT_TAG = "sft lora dense TinyLlama-1.1B"
SFT_INPUTS = (os.path.join("configs", "text", "lora_sft.yaml"),
              os.path.join("tests", "fixtures", "tokenizers"), "README.md", "SURVEY.md", "docs")
# the deepseek faults run chip_smoke.py's Moonlight phase alone; its router
# check, parameter count and layer check come before its trainer
MOONLIGHT = ("--phases", "hf_trainer_moonlight")
MOONLIGHT_LAYER = "Moonlight-16B-A3B layer check"
# the gpt_oss faults run chip_smoke.py's gpt-oss-20b phase alone; its load
# check and its layer check (layer 0, a 128-token window) come before its
# trainer
GPT_OSS = ("--phases", "hf_trainer_gpt_oss")
GPT_OSS_LAYER = "gpt-oss-20b layer check: layer 0"
DISAGREES = "the port's layer disagrees"
# the VLM faults run chip_smoke.py's Qwen2-VL-2B or Qwen2.5-VL-3B phase
# alone; its K1-K3 rows at D 80 and its checks against chip_smoke's own f32
# pieces come before its trainer
QWEN2_VL = ("--phases", "hf_trainer_qwen2_vl")
QWEN2_5_VL = ("--phases", "hf_trainer_qwen2_5_vl")
QWEN2_VL_CHECK = "hf vlm Qwen2-VL-2B check"
QWEN2_5_VL_CHECK = "hf vlm Qwen2.5-VL-3B check"
# the first small case of chip_smoke.py's grouped-GEMM phase: group sizes
# [100, 156, 0, 256], so m tile 3 (rows 384-511) belongs to expert 3 alone
# and expert 0's 100 rows are two 64-row chunks for K6
CASE = "(small ragged+empty, K=128 N=256)"
RUN_TIMEOUT_S = 900  # one faulted chip_smoke.py run stops at its check


class Fault(NamedTuple):
    name: str
    what: str
    source: str  # the file the edit applies to, relative to the repository root
    anchor: str  # occurs exactly once in source
    replacement: str
    check: str  # the chip_smoke.py check that must fail (its log line starts so)
    failure: str = ""  # its error message; default: the kernel-vs-plain one
    args: tuple = ()  # chip_smoke.py's arguments (a serving fault runs its phase alone)

    @property
    def error(self) -> str:
        return self.failure or f"{self.check}: kernel disagrees"


# K4 and K5 share one kernel template and one work schedule (the producer and
# the consumers walk it alike, so a fault there cannot leave the pipeline out
# of step); DLHS is true in K5. Running no contraction chunk for an expert
# leaves its accumulators at 0, which its epilogue writes to its rows.
_EXPERT_CALL = "    expert(m0, w0, e, lo, hi, nchunks);\n"


def _skip_first_expert(kernel: str) -> str:
    """The expert call with the fault, in the kernel that ``kernel`` selects."""
    return (f"    expert(m0, w0, e, lo, hi, ({kernel} && m0 == 3 * BM && w0 == 0 &&\n"
            "                               e == first_expert(gs, E, m0)) ? 0 : nchunks);\n")


FAULTS = (
    Fault("K4", "K4 skips the first expert of (m tile 3, n tile 0): its rows come out 0",
          GMM_SOURCE, _EXPERT_CALL, _skip_first_expert("!DLHS"),
          f"K4 out (autograd path) {CASE}"),
    Fault("K5", "K5 skips the first expert of (m tile 3, k tile 0): its rows come out 0",
          GMM_SOURCE, _EXPERT_CALL, _skip_first_expert("DLHS"),
          f"K5 dlhs (autograd path) {CASE}"),
    # the consumers take every row of chunk 1 of expert 0 for a row of the next
    # expert and zero it in the lhs stage: that chunk adds nothing (the
    # producer and the consumers still walk the same chunks)
    Fault("K6", "K6 zeroes 64-row chunk 1 of expert 0 in the lhs stage",
          GMM_SOURCE, "const int valid = min(hi - (lo + c * BK), BK);",
          "const int valid = (e == 0 && c == 1) ? 0 : min(hi - (lo + c * BK), BK);",
          f"K6 drhs (autograd path) {CASE}"),
    # the shared walk of K1 skips k tile 0 for q tile 1 (rows 128-255): every
    # row of the dense path's first batch begins with a document of 256 or
    # more tokens, so the pair is visible in every row and head
    Fault("K1", "K1 skips the pair (q tile 1, k tile 0) in the walk both roles share",
          FLASH_SOURCE, "if (disjoint(qr, kr)) continue;  // no visible pair",
          "if (disjoint(qr, kr) || (q0 == 128 && k0 == 0)) continue;  // no visible pair",
          "K1 O (autograd path, Qwen3-0.6B layout)"),
    # the shared walk of K2 skips q tile 2 (rows 128-191) of the first q head
    # of every work item for key tile 0: visible in every row of that batch
    Fault("K2", "K2 skips the pair (first q head, q tile 2) of key tile 0 in the walk both "
                "roles share",
          FLASH_SOURCE, "if (disjoint(kr, qr)) continue;  // no visible pair",
          "if (disjoint(kr, qr) || (h == h0 && q0 == 128 && k0 == 0)) continue;  // no visible pair",
          "K2 dK (Qwen3-0.6B layout)"),
    # the walk K1 and K3 share skips, at K3's 64-key tiles only, k tile 0 for
    # q tile 1 (rows 128-255): visible in every row and head of that batch
    Fault("K3", "K3 skips the pair (q tile 1, k tile 0) in its walk (K1's 128-key walk as it is)",
          FLASH_SOURCE, "if (disjoint(qr, kr)) continue;  // no visible pair",
          "if (disjoint(qr, kr) || (KT == 64 && q0 == 128 && k0 == 0)) continue;  // no visible pair",
          "K3 dQ (Qwen3-0.6B layout)"),
    # at the Qwen3-30B-A3B head layout and micro-batch 1 K2 splits each group
    # of 8 q heads over 4 work items; the fixed-order sum leaves out dV's
    # last partial (the MoE main path's micro-batch 4 takes no split)
    Fault("K2-split", "K2's fixed-order sum of the split partials leaves out dV's last split",
          FLASH_SOURCE, "for (int p = 1; p < split; ++p) {",
          "for (int p = 1; p < split - which; ++p) {",
          "K2 dV (Qwen3-30B-A3B, micro-batch 1)"),
    # K1 at head dim 64 reads Q's 32-byte chunks of each swizzled row in the
    # wrong order (chunk c for c ^ 1) while K's stay right: S = Q K^T pairs
    # the wrong head dims (D = 128 and 256 as they are)
    Fault("K1-d64-swizzle", "K1 at D = 64 reads Q's swizzled rows with chunks 0/1 and 2/3 "
                            "swapped in S = Q K^T",
          FLASH_SOURCE, "wgmma_ss<KT, 0>(s, wgmma_desc(qa + (kd / 4) * Q_BOX + off, 16, 1024),",
          "wgmma_ss<KT, 0>(s, wgmma_desc(qa + (kd / 4) * Q_BOX + (D == 64 ? off ^ 32 : off), 16, "
          "1024),",
          "K1 O (autograd path, TinyLlama-1.1B layout)"),
    # K4's epilogue leaves out the 64-column stores that reach past the
    # output's width: at N = 200 columns 192-199 are never written (K5 as it is)
    Fault("K4-n-tail", "K4 drops the TMA stores of the N tail (the boxes that reach past N)",
          GMM_SOURCE,
          "for (int j = 0; j < TN / 64; ++j) tma_store_2d(map_out, stg + j * BM * 128, w0 + 64 * j, m0);",
          "for (int j = 0; j < TN / 64; ++j)\n"
          "              if (DLHS || w0 + 64 * j + 64 <= W)\n"
          "                tma_store_2d(map_out, stg + j * BM * 128, w0 + 64 * j, m0);",
          "K4 out (autograd path) (small ragged+empty, K=136 N=200)"),
    # the HF load reads q_proj without its transpose: TinyLlama's q_proj is
    # square (2048 x 2048), so the shape check passes and the weights land
    # transposed
    Fault("hf-transposed-q", "hf_to_params loads q_proj untransposed ([out, in] for [in, out])",
          HF_IO_SOURCE,
          'put(param, fetch(f"layers.{i}.{suffix}", transpose), f"layers.{i}.{pname}")',
          'put(param, fetch(f"layers.{i}.{suffix}", transpose != (pname == "q_proj")), '
          'f"layers.{i}.{pname}")',
          "hf trainer:", "hf trainer: loaded parameters differ"),
    # the trainer phase's resumed leg B2 continues from step 3: restoring the
    # moments but not the update count restarts the learning-rate schedule,
    # so step 4's update takes lr(0) for lr(3) and step 5's loss departs
    Fault("resume-num-updates", "the restore copies parameters and AdamW moments but leaves "
                                "num_updates at 0",
          CKPT_SOURCE, '    train_state.optimizer.num_updates = int(opt["num_updates"])\n',
          "    train_state.optimizer.num_updates = 0\n",
          "trainer step 5:", "trainer resume: step 5 loss"),
    # ... and dropping the dataloader cursor feeds step 4 the first batch again
    Fault("resume-cursor", "auto-resume restores the train state but drops the dataloader "
                           "cursor",
          TRAINER_SOURCE, 'if extra.get("dataloader") and hasattr(self.dataloader, '
                          '"load_state_dict"):',
          'if False and extra.get("dataloader"):',
          "trainer step 4:", "trainer resume: step 4 loss"),
    # serving: each runs chip_smoke.py's dense serving phase alone (the
    # earlier phases do not run the serving code). The paged gather reads
    # every table entry's next block, so each slot attends over other rows
    Fault("serve-gather", "gather_block_kv reads the next block of every table entry",
          PAGED_SOURCE,
          "    k = k_pool[block_tables].reshape(s, nb * bs, hkv, d)\n"
          "    v = v_pool[block_tables].reshape(s, nb * bs, hkv, d)\n",
          "    nxt = (block_tables + 1) % k_pool.shape[0]\n"
          "    k = k_pool[nxt].reshape(s, nb * bs, hkv, d)\n"
          "    v = v_pool[nxt].reshape(s, nb * bs, hkv, d)\n",
          "serve dense leg (a): re-score gate:", "serve dense leg (a): re-score gate",
          ("--phases", "serve_dense")),
    # the one-token decode step rotates its query and key one position late
    # (prefill and verify as they are)
    Fault("serve-rope", "paged_decode_step ropes at position + 1",
          DECODE_SOURCE,
          "    positions = positions[:, None]\n    tables = _rope_tables(cfg, positions)\n",
          "    positions = positions[:, None]\n    tables = _rope_tables(cfg, positions + 1)\n",
          "serve dense leg", "re-score gate", ("--phases", "serve_dense")),
    # a function the contiguous prefill shares with the paged steps: every
    # rotary table of the decode module is built at the default theta 10000
    # for Qwen3's 1e6, so the engine's first-token logits (which set no
    # tolerance: eps is the phase's recorded constant) move with the tokens
    Fault("serve-rope-theta", "_rope_tables builds its tables at theta 10000 (the decode "
                              "module's every step)",
          DECODE_SOURCE,
          "    cos, sin = ops.rotary_tables(positions, rope_dim, cfg.rope_theta,\n",
          "    cos, sin = ops.rotary_tables(positions, rope_dim, 10000.0,\n",
          "serve dense leg (a): re-score gate:", "serve dense leg (a): re-score gate",
          ("--phases", "serve_dense")),
    # the radix match claims the next block of a sibling path where the
    # prompt leaves the tree: its KV is another prompt's (the phase's
    # prefix-cache check fails too)
    Fault("serve-prefix", "PrefixCache.match reports one block more than it matched",
          PREFIX_SOURCE,
          "            if child is None:\n                break\n",
          "            if child is None:\n"
          "                if node.children:\n"
          "                    out.append(next(iter(node.children.values())).block)\n"
          "                break\n",
          "serve dense leg (a): re-score gate:", "serve dense leg (a): re-score gate",
          ("--phases", "serve_dense")),
    # the deepseek dialect: the sigmoid router picks its experts by score
    # alone, without the correction bias (the weights as they are)
    Fault("deepseek-bias", "route_tokens leaves the correction bias out of the expert choice",
          MODEL_SOURCE, "        choice = scores + correction_bias.float()\n",
          "        choice = scores + 0 * correction_bias.float()\n",
          "router check (DeepSeek-V3 width):", "router check (DeepSeek-V3 width): routing "
                                                "disagrees", MOONLIGHT),
    Fault("deepseek-shared", "moe_mlp drops the shared experts",
          MODEL_SOURCE, "    if shared is not None:\n        combined = combined +",
          "    if False:\n        combined = combined +",
          f"{MOONLIGHT_LAYER}: MoE block", f"{MOONLIGHT_LAYER}: MoE block: the port's layer "
                                           "disagrees", MOONLIGHT),
    # MLA's rope with the llama half rotation on the interleaved tables
    Fault("deepseek-rope-half", "MLA's rope turns the two halves (llama) for adjacent pairs",
          MODEL_SOURCE, "interleaved=cfg.rope_interleave)", "interleaved=False)",
          f"{MOONLIGHT_LAYER}: MLA q/k", f"{MOONLIGHT_LAYER}: MLA q/k: the port's layer "
                                         "disagrees", MOONLIGHT),
    # the leading dense layer built and routed as a MoE layer
    Fault("deepseek-dense-as-moe", "first_k_dense_replace ignored: every layer is a MoE layer",
          MODEL_SOURCE,
          "self.is_moe = cfg.is_moe and layer_idx >= cfg.first_k_dense_replace",
          "self.is_moe = cfg.is_moe",
          "hf deepseek Moonlight-16B-A3B:", "parameters, the config gives", MOONLIGHT),
    # the gpt_oss dialect: the sinks left out of the attention
    Fault("gpt-oss-sinks", "the decoder layer attends without its sinks",
          MODEL_SOURCE,
          'sinks = self.w("sinks").to(self.cfg.dtype) if hasattr(self, "sinks") else None',
          "sinks = None",
          f"{GPT_OSS_LAYER} attention block", f"{GPT_OSS_LAYER} attention block: {DISAGREES}",
          GPT_OSS),
    # the fused gate_up tensor read as two contiguous halves, as qwen3_vl_moe
    # stores it (the shapes still fit)
    Fault("gpt-oss-halves", "hf_to_params splits the fused gate_up into contiguous halves",
          HF_IO_SOURCE, "x = halves[name][..., parity::2]",
          "x = halves[name].chunk(2, -1)[parity]",
          "hf gpt_oss gpt-oss-20b:", "loaded parameters differ from the written ones", GPT_OSS),
    Fault("gpt-oss-clamp", "the clamped GLU leaves out both clamps",
          SWIGLU_SOURCE,
          "        gate = torch.clamp(gate, max=GPT_OSS_LIMIT)\n"
          "        up = torch.clamp(up, min=-GPT_OSS_LIMIT, max=GPT_OSS_LIMIT)\n", "",
          f"{GPT_OSS_LAYER} MoE block", f"{GPT_OSS_LAYER} MoE block: {DISAGREES}", GPT_OSS),
    # the weights of the generic softmax branch: the top k of a softmax over
    # all experts, not renormalised (renormalised, they equal the gpt_oss
    # weights)
    Fault("gpt-oss-softmax-first", "gpt_oss routing takes the softmax over all experts before "
                                   "the top-k",
          MODEL_SOURCE,
          "        topk_logits, topk_idx = _top_k(logits, k)\n"
          "        return (topk_idx, torch.softmax(topk_logits, dim=-1),",
          "        topk_w, topk_idx = _top_k(probs, k)\n        return (topk_idx, topk_w,",
          f"{GPT_OSS_LAYER} MoE block", f"{GPT_OSS_LAYER} MoE block: {DISAGREES}", GPT_OSS),
    Fault("gpt-oss-expert-bias", "the experts' gate/up/down biases are not added",
          MODEL_SOURCE,
          "    return t if bias is None else t + bias.to(dt)[expert_of_row]",
          "    return t",
          f"{GPT_OSS_LAYER} MoE block", f"{GPT_OSS_LAYER} MoE block: {DISAGREES}", GPT_OSS),
    # the VLM path: the tower's head dim 80 loaded and stored through the 2-D
    # map [B*S, H*80], whose second 64-column box of head h holds head h + 1's
    # first 48 columns
    Fault("K1-d80-2d-map", "K1-K3 at D 80 read and write through the 2-D map [B*S, H*80]",
          FLASH_SOURCE, "{ return DA != D; }", "{ return false; }",
          "K1 O (autograd path, Qwen2-VL-2B tower, per-frame segments)", args=QWEN2_VL),
    Fault("vision-rope-hw", "the vision rope turns the first half of the frequencies by the "
                            "column and the second by the row",
          VL_SOURCE, "    freqs = torch.cat([fh, fw], -1)\n",
          "    freqs = torch.cat([fw, fh], -1)\n",
          f"{QWEN2_VL_CHECK}: vision block 0", DISAGREES, QWEN2_VL),
    Fault("mrope-sections", "the mrope sections read the streams in reverse order (w, h, t)",
          ROTARY_SOURCE,
          "    return torch.cat([torch.full((n,), i % 3, dtype=torch.int64)",
          "    return torch.cat([torch.full((n,), 2 - i % 3, dtype=torch.int64)",
          f"{QWEN2_VL_CHECK}: text layer 0 (mrope)", DISAGREES, QWEN2_VL),
    Fault("vlm-reverse", "the Qwen2.5-VL tower returns its merged tokens in window order",
          VL_SOURCE, "        return y if reverse is None else y[reverse.long()]\n",
          "        return y\n", f"{QWEN2_5_VL_CHECK}: merger, image order", DISAGREES,
          QWEN2_5_VL),
    # HF's Conv3d weight [D, C, T, P, P] flattened as (C, Ph, Pw, T) both ways:
    # the HF directory round trip still holds, HF's patch layout does not
    Fault("patch-embed-ctp", "the patch-embed weight is flattened as (C, Ph, Pw, T)",
          VL_SOURCE,
          "    return w.reshape(width, -1).t()\n\n\n"
          "def patch_embed_to_hf(w: torch.Tensor, vcfg) -> torch.Tensor:\n"
          "    return w.t().reshape(vcfg.width, vcfg.in_channels, vcfg.temporal_patch_size,\n"
          "                         vcfg.patch_size, vcfg.patch_size)\n",
          "    return w.permute(0, 1, 3, 4, 2).reshape(width, -1).t()\n\n\n"
          "def patch_embed_to_hf(w: torch.Tensor, vcfg) -> torch.Tensor:\n"
          "    return w.t().reshape(vcfg.width, vcfg.in_channels, vcfg.patch_size,\n"
          "                         vcfg.patch_size, vcfg.temporal_patch_size)"
          ".permute(0, 1, 4, 2, 3)\n",
          f"{QWEN2_VL_CHECK}: patch embed", DISAGREES, QWEN2_VL),
    # LoRA: the merge without its scale, every layer merged with layer 0's
    # A, the expert adapters never read, a frozen tensor updated, the user
    # turns of the llama2 template supervised
    Fault("lora-scale", "merge_weight adds A @ B without the scale",
          LORA_SOURCE, "    delta = torch.matmul(a.float(), b.float()) * scale\n",
          "    delta = torch.matmul(a.float(), b.float())\n",
          f"{SFT_TAG}: merged HF export", "merged export departs from W + scale * A @ B",
          SFT_DENSE),
    Fault("lora-layer", "each layer's merge reads layer 0's A",
          LORA_SOURCE, "        a = a[layer]\n", "        a = a[0]\n",
          f"{SFT_TAG}: merged HF export", "merged export departs from W + scale * A @ B",
          SFT_DENSE),
    Fault("lora-experts", "the MoE layer reads its experts without their adapters",
          MODEL_SOURCE, 'return SimpleNamespace(**{n: self.w(f"{sub}.{n}")',
          'return SimpleNamespace(**{n: self.get_parameter(f"{sub}.{n}")',
          "sft lora moe Qwen3-30B-A3B:", "adapters that never trained",
          ("--phases", "sft_lora_moe")),
    Fault("freeze-update", "with_param_groups gives a frozen tensor scale 1",
          OPTIM_SOURCE, "                return 0.0\n", "                return 1.0\n",
          "sft param groups TinyLlama-1.1B:", "parameter groups depart from the plain run",
          SFT_DENSE),
    Fault("label-mask", "the llama2 template supervises the user turns",
          TEMPLATE_SOURCE, "                labels += [IGNORE_INDEX] * len(t)\n",
          "                labels += t\n",
          SFT_TAG, "llama2 template: a user turn's text is supervised", SFT_DENSE),
    # the serving stack of slice D2 and the remat policies: each runs its
    # own chip_smoke.py phase alone. The int8 KV rows quantized with the
    # wrong axis's scale
    Fault("quant-scale-axis", QUANT_AXIS_WHAT, QUANT_SOURCE, QUANT_AXIS_ANCHOR,
          QUANT_AXIS_EDIT, QUANT_GATE_CHECK, QUANT_GATE_FAILURE, ("--phases", "serve_quant")),
    # the affinity key hashes the prompt's blocks 1-2 for blocks 0-1
    Fault("router-affinity", "the router's affinity key is off by one block",
          ROUTER_SOURCE,
          "                tuple(int(t) for t in prompt_ids[i * bs:(i + 1) * bs])\n",
          "                tuple(int(t) for t in prompt_ids[(i + 1) * bs:(i + 2) * bs])\n",
          "serve router: affinity:", "serve router: affinity", ("--phases", "serve_router")),
    # a weight swap keeps the prefix cache: v1 requests reuse v0's KV
    Fault("publish-no-flush", "swap_weights leaves the prefix cache unflushed",
          ENGINE_SOURCE,
          "        flushed = self.prefix_cache.flush() if self.prefix_cache is not None else 0\n",
          "        flushed = 0\n",
          "serve router: publish flushed the prefix caches:",
          "publish flushed the prefix caches", ("--phases", "serve_router")),
    # offload parks nothing: it runs as dots, ctx_offload as ctx
    Fault("offload-noop", "the offload policies' hooks removed (offload runs as dots, "
                          "ctx_offload as ctx)",
          MODEL_SOURCE,
          "        elif policy == \"offload\":\n"
          "            kw[\"context_fn\"] = _host_matmul_contexts\n"
          "        q, k, v = checkpoint(self._qkv, hidden, cos, sin, **kw)\n"
          "        if policy.endswith(\"offload\"):\n",
          "        elif policy == \"offload\":\n"
          "            kw[\"context_fn\"] = _dots_contexts\n"
          "        q, k, v = checkpoint(self._qkv, hidden, cos, sin, **kw)\n"
          "        if False:\n",
          "remat: offload peak:", "offload peak", ("--phases", "remat")),
    # Muon applies its momentum unorthogonalised
    Fault("muon-no-ns", "Muon skips the Newton-Schulz orthogonalisation", MUON_SOURCE,
          "        orth = newton_schulz(batch)\n", "        orth = batch\n",
          "optimizers: muon update layers.q_proj layer 5:", "muon update layers.q_proj layer 5",
          ("--phases", "remat")),
    # the provenance names the layer after the first non-finite one
    Fault("numerics-layer-off-by-one", "first_nonfinite names the neighbouring layer",
          NUMERICS_SOURCE,
          "                        out[\"layer\"] = next(i for i, v in enumerate(vals) if v > 0)\n",
          "                        out[\"layer\"] = next(i for i, v in enumerate(vals) if v > 0) + 1\n",
          "trainer drills: nan drill provenance:", "nan drill provenance", ("--phases", "trainer")),
    # K1-K3 report no work to the cost census
    Fault("cost-no-kernel-flops", "the flash kernels report no FLOPs to the census",
          FLASH_WRAPPER_SOURCE,
          "    cost.note_kernel(lambda: flash_work(name, q, k, tensors[3], causal))\n", "",
          "trainer observatories: census kernel FLOPs:", "census kernel FLOPs",
          ("--phases", "trainer")),
    # the parallel layer (--phases parallel): FSDP2's default mean instead of
    # the sum the token normalisation needs
    Fault("fsdp-mean-not-sum", "FSDP2 averages the gradients over its group (its default)",
          PLAN_SOURCE,
          "            sub.set_gradient_divide_factor(1.0)\n"
          "            sub.set_force_sum_reduction_for_comms(True)\n",
          "            pass\n",
          "parallel dense step 1:", "parallel dense step 1: world 2 against world 1",
          ("--phases", "parallel")),
    # the router's balance loss from each rank's own statistics
    Fault("ep-aux-per-rank", "the load-balancing loss reads the rank's tokens only",
          MODEL_SOURCE,
          "    if ps is not None and ps.group(ps.dp_sp_axes) is not None:\n",
          "    if False:\n",
          "parallel moe step 1: moe_aux_loss", "parallel moe step 1: moe_aux_loss",
          ("--phases", "parallel")),
    # the all-to-all concatenates the received pieces in reverse rank order
    Fault("ulysses-head-order", "the all-to-all's pieces concatenated in reverse rank order",
          FUNCTIONAL_SOURCE,
          "    return torch.cat(recv.unbind(0), dim=concat_dim)\n",
          "    return torch.cat(recv.unbind(0)[::-1], dim=concat_dim)\n",
          "parallel dense step 1:", "parallel dense step 1: world 2 against world 1",
          ("--phases", "parallel")),
    # the redispatch after the soak's replica kill drops the first stranded request
    Fault("chaos-lost-id", "the redispatch after a chaos kill drops one stranded request",
          ROUTER_SOURCE,
          "        self._queue[:0] = sorted(requeue, key=lambda it: it.order)\n",
          "        self._queue[:0] = sorted(requeue, key=lambda it: it.order)[\n"
          "            int(\"chaos\" in h.fail_reason):]\n",
          "serve router: chaos soak exactly once:", "chaos soak exactly once",
          ("--phases", "serve_router")),
)


def plant(root: str, fault: Fault) -> None:
    """Apply ``fault`` to its source file under ``root``."""
    path = os.path.join(root, fault.source)
    with open(path) as f:
        text = f.read()
    if text.count(fault.anchor) != 1:
        raise RuntimeError(f"{fault.name}: anchor not found exactly once in {fault.source}")
    with open(path, "w") as f:
        f.write(text.replace(fault.anchor, fault.replacement))


def make_copy(dst: str) -> None:
    """What ``chip_smoke.py`` needs, plus the kernels already built here."""
    shutil.copytree(os.path.join(REPO, "veomni_tpu_torch"), os.path.join(dst, "veomni_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), dst)
    for name in SFT_INPUTS:
        src = os.path.join(REPO, name)
        if os.path.isdir(src):
            shutil.copytree(src, os.path.join(dst, name))
        else:
            os.makedirs(os.path.dirname(os.path.join(dst, name)), exist_ok=True)
            shutil.copy(src, os.path.join(dst, name))
    built = glob.glob(os.path.join(REPO, "build", "kernels", "*.so"))
    if built:
        os.makedirs(os.path.join(dst, "build", "kernels"))
        for lib in built:
            shutil.copy(lib, os.path.join(dst, "build", "kernels"))


def run_fault(fault: Fault, log_dir: str | None) -> dict:
    with tempfile.TemporaryDirectory(prefix="fault_check_") as tmp:
        make_copy(tmp)
        plant(tmp, fault)
        env = {**os.environ, "PYTHONPATH": tmp}
        proc = subprocess.run([sys.executable, "chip_smoke.py", *fault.args], cwd=tmp, env=env,
                              capture_output=True, text=True, timeout=RUN_TIMEOUT_S)
    out = proc.stdout + proc.stderr
    if log_dir:
        with open(os.path.join(log_dir, f"{fault.name}.log"), "w") as f:
            f.write(out)
    lines = [ln.strip() for ln in proc.stdout.splitlines() if ln.strip().startswith(fault.check)]
    # a check that logs its verdict (the serving phases) names the failure
    line = next((ln for ln in lines if "FAILED" in ln), lines[0] if lines else None)
    caught = (proc.returncode != 0 and '"ok": true' not in proc.stdout
              and fault.error in proc.stderr)
    return {"name": fault.name, "fault": fault.what, "rc": proc.returncode, "caught": caught,
            "check": fault.check, "line": line}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--log-dir", default=None, help="write each run's full output here")
    ap.add_argument("--only", default=None, help="comma-separated fault names (default: all)")
    args = ap.parse_args(argv)
    faults = [f for f in FAULTS if not args.only or f.name in args.only.split(",")]
    if args.log_dir:
        os.makedirs(args.log_dir, exist_ok=True)
    results = []
    for fault in faults:
        print(f"{fault.name}: {fault.what}\n  edit: {fault.anchor.strip()!r}\n"
              f"     -> {fault.replacement.strip()!r}", flush=True)
        r = run_fault(fault, args.log_dir)
        print(f"  exit {r['rc']}, caught={r['caught']}: {r['line']}", flush=True)
        results.append(r)
    ok = all(r["caught"] for r in results)
    print(json.dumps({"faults": results, "all_caught": ok}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

"""On-card smoke test of the PyTorch/H100 port (``veomni_tpu_torch``).

Run from the repository root on a machine with one NVIDIA Hopper card::

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. build the CUDA kernels from ``veomni_tpu_torch/csrc`` with ``nvcc`` (one
   process per source, all at once) and print the card, its power limit and
   the torch/CUDA versions;
2. launch the probe kernel K7 (``y = 2x``) and compare it exactly;
3. hold each flash-attention kernel (K1-K3) against its plain PyTorch
   version on the same inputs, in bf16, at the dense main path's attention
   shape (B=4, S=4096, Hq=16, Hkv=8, D=128, packed segments), at the MoE
   main path's (the same batch at Hq=32, Hkv=4: K2 walks each whole group
   of 8 q heads in one work item) and at the MoE model's micro-batch 1 (the
   first row alone, where K2 splits each group over 4 work items); time
   kernel, plain version and the library yardstick; compute each kernel's
   bound from this run's inputs, and time K1-K3 on a single-segment batch of
   the same shape (the function SDPA computes); then K1-K3 on edge cases:
   S = 128 (one tile), one segment, many short segments (boundaries inside
   the 128-row tiles), boundaries on tile edges, S = 384 (three 128-key
   tiles), causal and full, Hq/Hkv 4/2 and 32/4 (K2 splits the group 2 and
   8 ways), and a key tile whose walk is empty (its dK, dV and dQ must come
   out exactly 0); K2 and K3 are launched twice on the same inputs at every
   layout and in every edge case, and their dQ, dK and dV must be
   bit-identical; then the same at head dim 64 on the HF trainer phase's own
   first packed batch at TinyLlama-1.1B's heads (B=4, S=2048, Hq=32, Hkv=4)
   and on its first row (K2 splits each group 8 ways), and at head dim 256
   at Gemma-7B's heads (B=1, S=4096, Hq=16, Hkv=16);
4. the same for the grouped-GEMM kernels K4-K6 at the MoE main path's
   shapes (M = 131072 routed rows, E = 128, K/N = 2048/768 and 768/2048)
   with the group sizes of its real routing (layer 0 on the first packed
   batch), and on small cases with an empty expert, a single expert,
   boundaries in the middle of a tile, a row count that is not a multiple of
   the 128-row tile, fewer rows than one tile, rows that no expert owns
   (which must come out exactly 0 from K4 and K5; K6 must not count them),
   experts that end on an edge of K6's 64-row chunks, inside one, or hold
   fewer rows than one, empty experts (whose drhs K6 must write as exactly
   0) and 128 experts, most of them empty, with a boundary on a tile edge;
   then K and N multiples of 8 but not of the tiles (small cases at K=136
   N=200 and K=776 N=64, and the MoE routing at (K, N) = (2048, 776),
   (776, 2048) and the reference CLI config's (2048, 64));
5. drive the dense main path: Qwen3-0.6B (full width, 28 layers, f32 master
   weights, bf16 compute, ``ctx`` remat, AdamW) for 3 SFT train steps on
   packed seq-4096 batches of micro-batch 4, with every kernel launch
   counter set to 0 just before and read just after;
6. drive the MoE main path the same way: Qwen3-30B-A3B at full width, depth
   cut to 4 of 48 layers (a layer holds ~623 M parameters, ~10 GB with its
   f32 weight, grad and two AdamW moments), 3 steps, printing the router
   aux loss and the peak device memory; then the MoE router monitor
   (``utils/moe_monitor.py``) on its trained model: ``capture_router_stats``
   on the first micro-batch (a ``no_grad`` replay: K1 once and K4 three times
   a layer), each layer's expert load [4, 128] held to a count of the same
   routing by this script's own f32 router, and the gauges published;
7. the MoE step at micro-batch 1, the micro-batch of the repo's
   Qwen3-30B-A3B config (``configs/text/qwen3_moe_ep.yaml``), where K2 splits
   each q-head group over 4 work items: legs with the split and without it
   alternate, same seed, same batches, and their losses must agree;
8. drive the trainer (``veomni_tpu_torch.tasks.train_text``, the user's
   entry point) at Qwen3-0.6B's full width and depth on a seeded
   pretokenized corpus written to a temporary directory: leg A, six straight
   steps of ``TextTrainer`` from the parsed YAML (no final checkpoint: no
   check reads it); leg B1, three steps and an
   (async) checkpoint; leg B2, a fresh ``main()`` that auto-resumes from it
   and runs to six. B2's losses at steps 4-6 and its final parameters, AdamW
   moments and ``num_updates`` must equal leg A's bit for bit, K1-K3 must
   launch 28 times a step with no plain-path dispatch, and A's step-1 loss
   must equal the one ``train_text_step``'s ``build_train_step`` gives on
   the same initial weights and batch; it prints step ms, tokens/s, the
   checkpoint's size, save and restore seconds and peak memory. Every leg
   runs slice E's observatories (``observability_numerics_interval`` 2: the
   numerics sibling on steps 2, 4 and 6; ``observability_port`` -1;
   ``observability_fleet`` 1), and on leg A every exporter route is read
   over HTTP at step 3, the heartbeat file's step follows the steps, the
   numerics history holds steps 2, 4, 6 with per-layer vectors, the cost
   census's K1-K3 FLOPs equal this script's reckoning from the first
   batch's segments, the census ``train.mfu_pct`` over the meter's MFU lies
   in MFU_BAND at the hot steps 3 and 5; then, on leg A's trainer, a
   ``step.params`` nan drill whose provenance names ``layers.q_proj`` layer
   0, and a 4 TiB ``torch.empty`` whose out-of-memory post-mortem holds the
   buffer and cost censuses;
9. the HF-directory trainer: TinyLlama-1.1B (the published config.json,
   ``train_text_step.HF_CONFIGS``, hidden 2048, head dim 64, its depth cut
   to ``HF_LAYERS`` 11 of 22) as random bf16 weights from seed 0 written by the port's
   ``save_hf_checkpoint`` in three shards with an index, loaded back
   bit-equal; then ``TextTrainer`` on a YAML with ``config_path``,
   ``model_path``, ``dataset_type: streaming`` over 4 jsonl shards,
   ``dyn_bsz``, seq 2048 x micro-batch 4, prefetch 2, ``save_hf_weights``
   and deterministic algorithms for 4 steps: K1-K3 launch 11 times a step
   each, all at head dim 64, flash ``FALLBACK_CALLS`` stays 0, the exported
   HF directory reads back bit-equal to the final parameters, the step-1
   loss equals ``build_train_step``'s on the same weights and batch, and a
   leg with prefetch 0 gives the same losses bit for bit (neither leg writes
   a final checkpoint: no check reads one); it prints step ms, tokens/s,
   peak memory and the HF write, load and export seconds;
10. parity: at depth 2, full width, S=1024, one dense train step with the
   kernels against the same step with the plain attention pinned (loss,
   grad norm), and the q/k/v/o projection gradients of one backward, leaf
   by leaf; at depth 1 (where no grouped GEMM feeds the router, so both
   legs route alike), full width, S=1024, one MoE step with the grouped-GEMM
   kernels against the same step with the plain ragged impl pinned, and the
   router and expert gradients of one backward, leaf by leaf;
11. the dense HF dialects, each from an HF directory written by the
   port's ``save_hf_checkpoint`` (random bf16 weights from seed 0, Gemma's
   norm weights at 0 as HF initialises them, and the published config.json
   of ``train_text_step.HF_CONFIGS``) through
   ``TextTrainer`` at full width and depth, seq 4096 x micro-batch 4, f32
   master, bf16 compute, ctx remat, AdamW, each at half its published depth
   (``DIALECT_LAYERS``): Gemma-3-1B (13 of 26 layers, 2 full attention and
   11 with a 512-token window, head dim 256, 4/1 heads) for 3 steps with its
   HF export read back bit-equal, then Llama-3.2-1B (8 of 16 layers; llama3
   rope scaling, 32/8 heads, head dim 64) and Qwen2.5-1.5B (14 of 28; q/k/v
   biases, 12/2, head dim 128) for 2 steps each. K1-K3 launch once a step per
   full-attention layer, all at the model's head dim; FALLBACK_CALLS counts
   one a step per windowed layer (the reference's feature dispatch to the
   plain attention); the step-1 loss is held to the same step with the
   plain attention pinned (rel 1e-4). After each, K1-K3 are
   held and timed at its head layout on its own first packed batch
   (Gemma-3-1B also on its first row alone);
12. serve: the paged-KV engine (``veomni_tpu_torch.serving``) at Qwen3-0.6B,
   28 layers, over 8 requests in two waves, legs (a) prefix cache and
   512-token chunks, (b) neither, (c) (a) with ngram speculation, (d) (a)
   and (c) sampled; every token held to an f32 teacher-forced re-score
   through the training forward (eps a recorded constant per phase, and
   the engine's first-token spread held under a ceiling), no leaked block,
   pools that keep their storage, cached tokens within the shared prefix;
13. serve: after the dense phase of 12, Gemma-3-1B, all 26
   layers, leg (a) over 16 requests of 208-1921 tokens (8 behind a shared
   512-token prefix), so its 512-token windows bite, under the same gate;
14. the same at Qwen3-30B-A3B, 24 of its 48 layers in bf16, leg (a), with K4 on
   every MoE layer of every pass; the int8 tiers' quality gate on the same
   model (held at full width where phase 22's noise floor allows) and one
   engine leg with int8 KV blocks and int8 weights over 8 requests (K4 on
   every MoE layer of every pass, each token within eps of its own int8
   re-score); then K4 alone at the engine's decode and prefill-chunk
   shapes;
15. the deepseek MoE dialect (run after the dense dialects of 11): first
   ``route_tokens`` at DeepSeek-V3's router width (4096 tokens, hidden
   7168, 256 experts in 8 groups, top-4 groups, top-8, sigmoid with a
   nonzero correction bias) on the card against the same call on the CPU
   and against chip_smoke's own routing; then Moonlight-16B-A3B at its
   published widths (the config.json of ``train_text_step.HF_CONFIGS``),
   depth cut to 2 of 27 layers (the leading dense layer and 1 MoE layer), as random bf16 weights from seed 0 with router
   correction biases drawn nonzero, written to an HF directory: its
   parameter count against the one counted here from the config, its first
   MoE layer (MLA q/k, the MLA block, the MoE block) held token by token to
   chip_smoke's own f32 layer, then ``TextTrainer`` at seq 4096 x
   micro-batch 2 for 4 steps with its HF export read back bit-equal: K4
   launches 6 times, K5 and K6 3 times, per MoE layer and step, K1-K3
   never (MLA's v head dim is not q's: one ``FALLBACK_CALLS`` per layer and
   step), and the step-1 loss, grad norm and router aux loss equal the same
   step's with the plain ragged grouped GEMM pinned; then K4-K6 held and
   timed at its expert widths (K/N 2048/1408 and 1408/2048) on its layer
   1's routing of a packed batch (M = 49152); then DeepSeek-V2-Lite
   (softmax greedy routing without renorm, yarn rope with its mscale on the
   softmax scale) the same way at 2 layers for 3 steps;
16. the SFT path at ``configs/text/lora_sft.yaml``'s knobs (LoRA rank 16,
   alpha 32, conversation data at seq 4096 x micro-batch 2, lr 1e-4, the
   default ``nothing`` remat), run after the serving phases: chat rows
   built from the repo's docs; TinyLlama-1.1B from an HF directory (random
   bf16 weights, the byte-fallback fixture tokenizer of
   ``tests/fixtures/tokenizers``) with the llama2 template, after the label
   mask is checked with it and with the tokenizer's jinja template, 4
   steps: K1 twice and K2, K3 once per layer and step, every adapter
   trained, the base bit-unchanged, the adapter-only checkpoint, the
   adapter save/load round trip bit-equal, the merged HF export against
   ``W + scale * A @ B`` worked out here in f64, step 1 against the plain
   attention; then a full fine-tune with ``freeze_modules`` and
   ``module_lr_scales`` against a plain step (frozen tensor bit-unchanged,
   grad norm, update ratios); then Qwen3-30B-A3B at its preset widths, 16 of
   48 layers, ``moe_capacity_factor`` 2.0 at expert-parallel size 1,
   adapters on the experts and attention, the byte-level fixture tokenizer
   and chatml, 4 steps: K4 6, K5 and K6 3 times per layer and step on the
   merged experts, the base bit-unchanged, the adapter round trip, the
   last layer's merged weights against ``W + scale * A @ B`` worked out
   here in f64 (its merged export, ~42 GB of f32, is off), step 1's loss
   and grad norm against the plain ragged grouped GEMM;
17. the gpt_oss dialect (after the deepseek phases of 15): gpt-oss-20b at
   its published widths (the config.json of ``train_text_step.HF_CONFIGS``),
   depth cut to 2 of 24 layers (a 128-token window, full attention), as random bf16 weights from seed 0 (sinks
   from N(0, 1), biases drawn nonzero, the experts' gate/up weights and
   biases drawn large enough that the clamp and the biases show) written
   here in transformers' fused interleaved expert layout and loaded back
   bit-equal; its parameter count against the one counted here, layers 0
   and 1 held token by token to chip_smoke's own f32 layers (q/k under
   yarn with the correction range unrounded, attention with sinks and the
   window, top-4 of the biased router logits then a softmax over the 4,
   the clamped GLU with expert biases), then ``TextTrainer`` at seq 4096 x
   micro-batch 2 for 4 steps: K4 launches 6 times, K5 and K6 3 times, per
   layer and step, K1-K3 never (sinks take the reference's dispatch to the
   plain attention: one ``FALLBACK_CALLS`` per layer and step), step 1
   against the plain ragged grouped GEMM, the HF export read back
   bit-equal and its fused layout read from its files; then K4-K6 held and
   timed at K = N = 2880 on layer 0's routing (M = 32768); and, after the
   serving phase of 14, the engine at gpt-oss-20b, all 24 layers in bf16,
   leg (a) over 8 requests of 64-1536 tokens, then K4 alone at its decode
   shape (M = 32);
18. the vision-language trainer (``veomni_tpu_torch.tasks.train_vlm``'s
   ``VLMTrainer``) at Qwen2-VL-2B-Instruct's published config.json, the LM
   cut to 14 of 28 layers (hidden 1536, 12/2 heads of 128, mrope [16, 24,
   24]; tower 32 blocks of 1280, 16 heads of 80, nothing cut): an HF directory of random bf16
   weights from seed 0 (the checked q/k drawn wider) and a corpus of
   pretokenized rows with HWC uint8 images of 448 x 448, 336 x 672 and 224 x
   224 pixels, passed as arrays; K1-K3 at head dim 80, full attention, on
   the first micro-batch's per-frame segments (3072 patches, 640 of them
   padding), against their plain versions, K2/K3 bit-identical over two
   launches, timed beside the plain versions, SDPA with the same-segment
   mask and their bound; the loaded parameters against the written ones and
   the count from the config; the patch embed (HF's Conv3d weight read from
   the directory), vision block 0, the merger and its output order, and
   text layer 0 under mrope, each against chip_smoke's own f32 version,
   token by token; then 3 steps at seq 4096 x micro-batch 2 with
   ``data.max_patches`` 3072: K1-K3 launch once a micro-batch per tower
   block at D 80 and per text layer at D 128, ``FALLBACK_CALLS`` 0; step
   time, tokens/s, MFU with the tower's FLOPs, peak memory; the HF export
   read back bit-equal; step 1's loss and grad norm against the plain
   attention's;
19. the same at Qwen2.5-VL-3B-Instruct's published widths (tower 32 blocks
   of 1280 with windows of 112 pixels and full attention at blocks 7, 15,
   23 and 31; LM hidden 2048, 16/2 heads), the LM cut to 18 of 36 layers,
   K1-K3 on the per-window segments, 2 steps, no export;
20. the post-training trainers (run after the SFT phases of 16), each the
   class its entry point (``veomni_tpu_torch.tasks.train_text_{dpo,
   distill,rl}``) builds from the trainer phase's YAML (Qwen3-0.6B, full
   width, 28 layers, random weights from seed 0, seq 4096, ctx remat,
   deterministic algorithms; no final checkpoint): DPO with 2 pairs a
   micro-batch of random ids and ``data.eval_path`` at ``eval_steps`` 2 for
   3 steps (step 1's loss ln 2 a pair with ``dpo_acc`` 0, K1 twice a layer
   and step, the reference's forward under ``no_grad``, K2 and K3 once, K1
   twice a layer per eval; the reference policy bit-equal to the initial
   model after the steps, the policy not; two more ``evaluate()`` calls give
   the train-end ``eval_loss`` again and launch K1 alone); DPO with LoRA
   (rank 16, alpha 32) on TinyLlama-1.1B from an HF directory with the
   byte-fallback fixture tokenizer, text pairs from the repo's docs, seq
   2048, 2 steps (step 1 ln 2 against the bare base, the base bit-unchanged,
   every adapter trained, K1-K3 at D 64); distillation with
   ``distill_topk`` 8 on rows of 2048-4096 tokens whose teacher top-8 ids
   and log-probs come from a ``no_grad`` forward of the same initial model
   (step 1's ``distill_kl`` within 1e-3 of 0, the two top-k masses within
   1e-3); RL on prompts of 128-512 and responses of 512-2048 tokens with
   advantages from N(0, 1), half the rows carrying the initial policy's
   ``old_logprobs`` and half the on-policy sentinel (step 1's
   ``ratio_mean`` within 1e-2 of 1); and ``TextTrainer`` with a two-channel
   ``data.channel_list`` for 2 steps (each step's per-channel sums add up to
   its loss sum, rel 1e-5, and the counts to ``ntokens``). K1-K3 launch
   as reckoned on every leg, ``FALLBACK_CALLS`` 0.

21. the remat policies (after the dense main path of 5): the bare loop at
   Qwen3-0.6B (28 layers, seq 4096 x micro-batch 4) for 2 steps under each
   of ``nothing``, ``ctx``, ``dots``, ``offload`` and ``ctx_offload``, and
   under ``ctx`` with ``chunk_mbs`` 1024: K1-K3 as reckoned (K1 twice a layer
   and step under ``nothing``, once under the others), step 1's loss
   bit-equal across the five, the grad norm against ``ctx``'s (limit 1e-3;
   ``chunk_mbs``: loss 1e-4 too), the offload policies' device peaks below
   ``dots``'s and ``ctx``'s; step ms and peak memory a policy; then under
   ``ctx`` 2 steps with ``optimizer: muon`` and one with each of
   ``anyprecision_adamw``, ``adafactor`` and ``sgd``: step 1's loss equal to
   the AdamW leg's, K1-K3 28 times a step, and step 2's Muon update of
   ``q_proj`` (layer 5), ``down_proj`` (20), ``o_proj`` (27) and the stacked
   ``[28, 1024]`` ``input_layernorm`` (orthogonalised jointly) against this
   script's own float64 Newton-Schulz of the same momentum (MUON_TOL);
22. the int8 serving tiers (after the dense serving phase of 12) at
   Qwen3-0.6B, 28 layers in bf16: the quality gate's noise floor (the dense
   bf16 path against itself at f32) and the gate of int8 KV, int8 weights
   and both against the dense path on the fixed corpus (the repo's pinned
   bounds: ppl rel delta 0.02, top-8 overlap 0.90; held at full width where
   the floor is inside them, else on the qwen3, gpt_oss-like and qwen3_moe
   toys they were pinned on), a planted 4x ``o_proj`` scale that must break
   them; then the engine in each int8 mode over serve dense's 8 requests
   (every token within eps of its own int8 teacher-forced re-score, no
   leaked block, pools unmoved) and the pool bytes a block and
   ``max_concurrent_seqs`` at equal pool bytes against the dense pool;
23. the replica router: 2 replicas of Qwen3-0.6B (8 slots each) behind
   ``Router`` on serve dense's traffic, beside one engine on the same
   traffic: affinity keys and rendezvous targets against this script's
   own; a clean run (aggregate tok/s, spills, hit rate); a ``raise`` at one
   replica's first decode tick (its unstreamed requests redispatched, every
   id finished exactly once, the respawn through probation); a ``hang``
   there under ``replica_stall_s`` 3 (a wedge declared before the 10 s hang
   ends, the respawn through probation); ``publish_from_checkpoint`` of a
   truncated generation refused with no replica moved, then of a second
   weight set (seed 1, written by ``Checkpointer``) rolled in mid-traffic:
   each prefix cache flushed, requests before the roll held to the old
   weights, after it to the new; every token through the re-score gate;
   then ``/healthz`` and ``/debug/router`` read over HTTP from the exporter,
   and a seeded ``run_chaos_soak`` (CHAOS_SEED: a replica kill, a weight
   publish, two delays over a 4 s storm of 20 requests) over the same two
   replicas: every id completes exactly once, no block leaks, the fleet is
   restored and every replica serves the published version; its goodput is
   logged, not gated;
24. ``python -m veomni_tpu_torch.tasks.infer_text`` as a subprocess on
   Qwen3-0.6B (28 layers, the embedding cut to the byte-fallback fixture
   tokenizer's 4096 ids) with two prompts on stdin, started beside the
   kernel build of 1 and waited for right after it, before the first timed
   phase: its output lines equal the decode of ``greedy_generate``'s ids.

25. the parallel layer (after the parities of 10): two ranks on the one card
   (``parallel/launch.py::run_ranks`` with the launcher's environment),
   each building ``TextTrainer`` from a YAML, which joins the world itself
   and picks gloo (NCCL refuses two ranks on one device): Qwen3-0.6B at
   full depth, seq 4096, 4 rows, ulysses 2 (K1-K3 at a rank's 8/4 heads
   after the all-to-all), trained a step and checkpointed there, then a
   fresh trainer restores that checkpoint and trains step 2; then
   Qwen3-30B-A3B's widths at 2 layers, one row a rank, ep 2 (64 experts a
   rank, dropless buckets, K4-K6 on the capacity-padded local groups);
   FSDP2 shards the dense weights. Each leg's loss, grad norm (and the
   balance loss) at steps 1-2 against the same trainer at world size 1 on
   the same documents within PARALLEL_TOL (4x a measured floor), both ranks
   equal, the restart's state equal to the saved one, K1-K6 launching in
   each rank as reckoned with no plain attention dispatch, the collective
   census of step 1 equal by kind to the bytes
   ``observability/comm.py::plan_step_bytes`` reckons from the plan; then
   K1-K3 at the rank's head layout on the dense batch and K4-K6 at rank 0's
   local expert groups (routed at world 1 on the same weights and rows)
   against their plain versions (timed at the gate/up shape). Each leg's
   transport is printed from what the ranks report.

``--phases serve_dense,serve_quant,serve_moe`` runs the build and those phases alone
(after ``main`` or ``trainer``, the dense loop or the trainer, when named
first) and prints no result line; ``--phases
hf_trainer_gemma3,serve_gemma3,dialects`` runs the dense dialects' phases
(11 and 13) alone, ``--phases hf_trainer_moonlight,deepseek_v2_lite`` the
deepseek ones (15), ``--phases sft_lora_dense,sft_lora_moe`` the SFT ones
(16), ``--phases hf_trainer_gpt_oss,serve_gpt_oss`` the gpt_oss ones (17),
``--phases hf_trainer_qwen2_vl,hf_trainer_qwen2_5_vl`` the VLM ones (18, 19),
``--phases moe,post_training`` the MoE path with its monitor (6) and the
post-training trainers (20), ``--phases parallel`` the parallel layer (25),
``--phases parallel_floor``, which no whole run includes, the floors its
tolerances come from,
``--phases remat,serve_quant,serve_router,
infer_text`` the phases 21-24 (``serve_moe`` needs ``serve_quant`` named before
it: the MoE gate reads its noise floor), and ``--phases vlm_witness``, which
no whole run includes, the VLM step-1 parity's witness: the step at other
text depths and weight seeds, with the attention of the tower and of the
text layers each pinned to the plain version in turn. Each partial run logs each phase's seconds
(``phase clock``).

The last three lines are the kernel table as JSON, the card's name and power
limit as ``nvidia-smi`` gives them, and the device record
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

# Kernel vs plain version, held element by element:
#   |got - ref| <= ATOL_ROW * rms(ref row) + ATOL_MAX * max|ref| + RTOL * |ref|,
# where a row is one token's head vector (D values). The kernels feed P and dS
# to the tensor cores as bf16 (2^-9 relative each) where the plain version
# keeps f32, and both store O/dQ/dK/dV as bf16, so an output may land on the
# neighbouring bf16 value (up to 2^-7 relative): RTOL is two bf16 epsilons.
# An output near zero is a sum of larger terms and keeps their rounding, which
# scales with the row's magnitude (not the tensor's, which the first tokens of
# each document dominate): ATOL_ROW is 2% of the row's RMS. A row whose exact
# value is zero (a document's first token sees one key, so its dQ is 0) holds
# only the f32 rounding of dP - delta: ATOL_MAX, 1e-4 of the tensor's largest
# magnitude, covers it. One 64x64 (query, key) tile pair skipped in one head
# of a long document breaks the rule several times over. The LSE is f32 end
# to end.
RTOL = 1.6e-2
ATOL_ROW = 2e-2
ATOL_MAX = 1e-4
TOL_LSE = 1e-4
# One train step, kernels vs plain attention: loss and grad norm (measured
# 1.4e-6 and 2.7e-5 on an H100). Then each q/k/v/o projection gradient after
# one backward, as |g_kernels - g_plain| / |g_plain| (measured 1.0e-2 to
# 1.9e-2 on an H100): with bf16 activations any difference in the attention
# output flips bf16 roundings downstream, and the plain path rounds dP to
# bf16 before it subtracts delta, so this holds the pair at bf16 resolution.
# It catches a wrong mask, scale or head mapping (errors of order 1); the
# kernel phase's elementwise rule catches the small ones. The MoE step parity
# (grouped-GEMM kernels vs the plain ragged impl, depth 1) is held to the
# same limits: measured loss 1.9e-6, grad norm 9.1e-6, router and expert
# gradients 8.5e-4 to 2.3e-3 on an H100 (one bf16 rounding flip per
# differing expert output).
TOL_LOSS_REL = 1e-4
TOL_GRAD_NORM_REL = 1e-3
TOL_LEAF_REL = 5e-2
# Grouped GEMM vs its plain version, element by element:
#   |got - ref| <= GMM_ATOL_MAX * max|ref| + GMM_RTOL * |ref|.
# Both multiply exact bf16 products and accumulate in f32, then round once to
# bf16; only the summation order differs, so an output may land on the
# neighbouring bf16 value: GMM_RTOL is one bf16 epsilon (2^-7). Outputs near
# zero keep the f32 rounding of their larger terms: GMM_ATOL_MAX is 1e-4 of
# the tensor's largest magnitude. A skipped (tile, expert) pair zeroes whole
# outputs, a 64-row chunk of K6 lost moves drhs by ~sqrt(64 / rows of the
# expert) of its size: each breaks the rule many times over.
GMM_RTOL = 2.0 ** -7
GMM_ATOL_MAX = 1e-4
LAYERS = 28
MOE_PRESET = "qwen3_30b_a3b"
MOE_LAYERS = 4
MAIN_STEPS = 3
MB1_STEPS = 4  # per leg of the micro-batch-1 MoE step; the first two warm up
TRAINER_SAVE_AT = 3  # the trainer phase's resumed leg saves here, then runs to 6
# the HF-directory trainer phase: TinyLlama-1.1B (train_text_step.HF_CONFIGS)
HF_PRESET = "tinyllama_1p1b"
HF_STEPS = 4  # cut with the remat and int8 serving phases (was 6)
HF_SEQ = 2048  # the model's own context (max_position_embeddings)
HF_MICRO_BS = 4
HF_DOCS = 512
# half its 22 layers, cut when slice E's checks joined the script (to keep the
# whole run under 1100 s); every check of the phase stays
HF_LAYERS = 11
HF_SHARD_BYTES = 1 << 29  # its 1.2 GB of bf16 weights in three shards: the index path runs
# the numbers of a flash kernel's row that are kept for its other layouts
LAYOUT_KEYS = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
               "single_segment_ms")


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def timed_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def phase_build(sources):
    from veomni_tpu_torch.ops.cuda import build

    with ThreadPoolExecutor(len(sources)) as pool:  # one nvcc per source, all at once
        paths = list(pool.map(build.build, sources))
    for p in paths:
        log(f"built {p}")
        # ptxas' report per kernel (the .log beside the library): registers,
        # spills, and wgmma serialization warnings
        kernel = None
        if not os.path.exists(p + ".log"):
            continue
        with open(p + ".log") as f:
            for line in f:
                if "Compiling entry function" in line:
                    # the mangled name without its namespace and parameters:
                    # the kernel and its template arguments (ILi64E... = <64, ...>)
                    kernel = re.sub(r"^.*?_cu_[0-9a-f]+\d+", "", line.split("'")[1])
                    kernel = kernel.split("EEv")[0].split("Ev")[0][:60]
                elif kernel and ("registers" in line or "spill" in line or "C75" in line):
                    log(f"  ptxas {kernel}: {line.strip()[:160]}")


def visible_pairs(seg: torch.Tensor, causal: bool = True) -> int:
    """Same-segment (query, key) pairs, causal or all of them: the work this
    data needs (the padding, segment 0, attends to itself as the kernels
    and the reference do)."""
    total = 0
    for row in seg.cpu().tolist():
        counts = {}
        for s_id in row:
            counts[s_id] = counts.get(s_id, 0) + 1
            total += counts[s_id]
        if not causal:
            total = total - sum(c * (c + 1) // 2 for c in counts.values()) \
                + sum(c * c for c in counts.values())
    return total


def kept_tiles(seg: torch.Tensor, bq: int, bk: int, causal: bool = True) -> float:
    """Share of the (q tile, k tile) pairs a walk visits (causal: up to the
    diagonal) whose segment-id ranges overlap, i.e. that the kernels'
    segment skip still computes."""
    kept = total = 0
    for row in seg.cpu():
        q_lo, q_hi = row.view(-1, bq).amin(1)[:, None], row.view(-1, bq).amax(1)[:, None]
        k_lo, k_hi = row.view(-1, bk).amin(1)[None, :], row.view(-1, bk).amax(1)[None, :]
        walked = (torch.arange(k_lo.shape[1])[None, :] * bk
                  <= torch.arange(q_lo.shape[0])[:, None] * bq + bq - 1)
        if not causal:
            walked = torch.ones_like(walked)
        overlap = ~((q_hi < k_lo) | (k_hi < q_lo))
        kept += int((walked & overlap).sum())
        total += int(walked.sum())
    return kept / total


def bound_ms(dev, flops: float, nbytes: float):
    """Least time for the work at the card's data-sheet peaks (bf16 tensor
    cores, device memory), and which of the two bounds it."""
    from veomni_tpu_torch.utils.device import get_device_peak_bandwidth, get_device_peak_flops

    t_ops = flops / get_device_peak_flops(dev)
    t_bytes = nbytes / get_device_peak_bandwidth(dev)
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def check_close(name: str, got: torch.Tensor, ref: torch.Tensor, atol=None, rtol=RTOL) -> float:
    """Hold ``got`` to ``ref`` element by element (``atol`` defaults to
    ATOL_ROW of each row's RMS plus ATOL_MAX of the largest |ref|); log the
    worst error/allowed ratio and return the largest absolute error."""
    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    if atol is None:
        atol_txt = f"{ATOL_ROW:g}*rms(row) + {ATOL_MAX:g}*max|ref|"
        atol = (ATOL_ROW * ref.pow(2).mean(-1, keepdim=True).sqrt()
                + ATOL_MAX * ref.abs().max())
    else:
        atol_txt = f"{atol:g}"
    allowed = atol + rtol * ref.abs()
    ratio = (err / allowed.clamp_min(1e-30)).max().item()  # 0 where both are 0
    n_over = int((~(err <= allowed)).sum())  # NaN counts as over
    max_err = err.max().item()
    log(f"  {name}: max_abs_err={max_err:.3e} (ref max {ref.abs().max().item():.3e}); "
        f"worst |err| / ({atol_txt} + {rtol:g}*|ref|) = {ratio:.3f}, {n_over} elements over")
    if not math.isfinite(ratio) or ratio > 1:
        raise AssertionError(f"{name}: kernel disagrees with its plain version "
                             f"({n_over} elements over the tolerance, worst ratio {ratio})")
    return max_err


def check_deterministic(tag, q, k, v, seg, do, lse, delta, scale, causal, rng):
    """K2 and K3 twice on the same inputs: dQ, dK and dV must be bit-identical
    (no atomics, fixed summation orders)."""
    from veomni_tpu_torch.ops.cuda import flash_attention as fa

    runs = [(*fa.flash_bwd_dkv_cuda(q, k, v, seg, do, lse, delta, scale, causal, rng),
             fa.flash_bwd_dq_cuda(q, k, v, seg, do, lse, delta, scale, causal, rng))
            for _ in range(2)]
    torch.cuda.synchronize()
    for name, a, b in zip(("K2 dK", "K2 dV", "K3 dQ"), *runs):
        if not torch.equal(a, b):
            raise AssertionError(f"{name} ({tag}): two launches on the same inputs differ in "
                                 f"{int((a != b).sum())} elements")
    log(f"  K2 dK, dV and K3 dQ ({tag}): bit-identical over two launches")


def phase_probe(dev):
    """K7 first: does a kernel run on this card at all? Exact comparison."""
    from veomni_tpu_torch.ops.cuda import probe

    x = torch.arange(8 * 128, dtype=torch.float32, device=dev).reshape(8, 128)
    y = probe.probe_double_cuda(x)
    torch.cuda.synchronize()
    if not torch.equal(y, probe.probe_double_plain(x)):
        raise AssertionError("K7 probe: kernel output differs from 2 * x")
    log("K7 probe: y = 2x on [8,128] f32, exact")
    bound = bound_ms(dev, 0.0, 2 * x.numel() * 4)
    return dict(name="probe_double", route="cuda", source="veomni_tpu_torch/csrc/probe.cu",
                replaces="scripts/pallas_probe.py:68", max_abs_err=0.0,
                ms=timed_ms(lambda: probe.probe_double_cuda(x), reps=100),
                plain_ms=timed_ms(lambda: probe.probe_double_plain(x), reps=100),
                bound_ms=bound[0], bound_by=bound[1],
                library_ms=timed_ms(lambda: torch.mul(x, 2.0), reps=100))


def phase_flash(dev, seg, hq: int, hkv: int, tag: str, d: int = 128, causal: bool = True):
    """K1-K3 at head dim ``d`` against their plain versions on packed
    segments ``seg``, causal or full (a vision tower's), timed beside their
    plain versions and the library yardstick: SDPA on a single-segment batch
    of the same shape for causal rows, SDPA with the same-segment mask (one
    call computing the same function) for full ones."""
    from veomni_tpu_torch.ops.cuda import flash_attention as fa

    b, s = seg.shape
    scale = d ** -0.5
    g = torch.Generator(device=dev).manual_seed(1)
    q = torch.randn(b, s, hq, d, device=dev, generator=g).bfloat16()
    k = torch.randn(b, s, hkv, d, device=dev, generator=g).bfloat16()
    v = torch.randn(b, s, hkv, d, device=dev, generator=g).bfloat16()
    do = torch.randn(b, s, hq, d, device=dev, generator=g).bfloat16()
    pairs = visible_pairs(seg, causal)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    split = fa.dkv_group_split(b, s, hq, hkv, n_sm, d)
    fwd_keys = 64 if d == 256 else 128  # K1's key tile
    kind = "causal" if causal else "full"
    n_pairs = b * s * (s + 1) / 2 if causal else b * s * s
    log(f"flash kernels ({tag}): B={b} S={s} Hq={hq} Hkv={hkv} D={d}, {kind}, "
        f"{int(seg.max())} segments max/row, {int((seg == 0).sum())} padding tokens "
        f"(segment 0), visible {kind} pairs {pairs} ({pairs / n_pairs:.3f} of {kind}); "
        f"{kind} tile pairs kept by the segment skip: "
        f"{kept_tiles(seg, 128, fwd_keys, causal):.3f} (K1: 128 q x {fwd_keys} keys), "
        f"{kept_tiles(seg, 64, 128, causal):.3f} (K2: 64 q x 128 keys), "
        f"{kept_tiles(seg, 128, 64, causal):.3f} (K3: 128 q x 64 keys); "
        f"K2's q-head group split {split}{', dK/dV in two 128-column halves' if d == 256 else ''}"
        f"{'; D 80 computed at D 128 tiles over 3-D maps (1.6x the products)' if d == 80 else ''}")

    # K1 through the autograd Function, then K2 + K3 from its backward
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    out = fa.flash_attention(qg, kg, vg, segment_ids=seg, causal=causal, softmax_scale=scale)
    out.backward(do)
    rng = fa.seg_ranges(seg)  # once per attention call on the main path: outside the timings
    o_k, lse_k = fa.flash_fwd_cuda(q, k, v, seg, scale, causal, rng)
    torch.cuda.synchronize()
    o_p, lse_p = fa.flash_fwd_plain(q, k, v, seg, scale, causal)
    err_o = check_close(f"K1 O (autograd path, {tag})", out, o_p)
    check_close(f"K1 O (wrapper, {tag})", o_k, o_p)
    err_lse = check_close(f"K1 LSE ({tag})", lse_k, lse_p, atol=TOL_LSE, rtol=0.0)
    delta = (do.float() * o_k.float()).sum(-1).transpose(1, 2).contiguous()
    dq_p, dk_p, dv_p = fa.flash_bwd_plain(q, k, v, seg, do, lse_k, delta, scale, causal)
    err_dq = check_close(f"K3 dQ ({tag})", qg.grad, dq_p)
    err_dk = check_close(f"K2 dK ({tag})", kg.grad, dk_p)
    err_dv = check_close(f"K2 dV ({tag})", vg.grad, dv_p)
    del o_p, lse_p, dq_p, dk_p, dv_p, qg, kg, vg, out
    torch.cuda.empty_cache()
    check_deterministic(f"{tag}, K2 split {split}", q, k, v, seg, do, lse_k, delta, scale, causal,
                        rng)

    ms = {
        "fwd": timed_ms(lambda: fa.flash_fwd_cuda(q, k, v, seg, scale, causal, rng)),
        "dkv": timed_ms(lambda: fa.flash_bwd_dkv_cuda(q, k, v, seg, do, lse_k, delta, scale,
                                                      causal, rng)),
        "dq": timed_ms(lambda: fa.flash_bwd_dq_cuda(q, k, v, seg, do, lse_k, delta, scale,
                                                    causal, rng)),
    }
    # K1-K3 on a single-segment batch of the same shape: the function SDPA
    # computes without a mask, so their like-for-like yardstick
    seg1 = torch.zeros_like(seg)
    rng1 = fa.seg_ranges(seg1)
    _, lse1 = fa.flash_fwd_cuda(q, k, v, seg1, scale, causal, rng1)
    single = {
        "fwd": timed_ms(lambda: fa.flash_fwd_cuda(q, k, v, seg1, scale, causal, rng1)),
        "dkv": timed_ms(lambda: fa.flash_bwd_dkv_cuda(q, k, v, seg1, do, lse1, delta, scale,
                                                      causal, rng1)),
        "dq": timed_ms(lambda: fa.flash_bwd_dq_cuda(q, k, v, seg1, do, lse1, delta, scale,
                                                    causal, rng1)),
    }
    del lse1
    plain_fwd = timed_ms(lambda: fa.flash_fwd_plain(q, k, v, seg, scale, causal), reps=3,
                         warmup=1)
    plain_bwd = timed_ms(lambda: fa.flash_bwd_plain(q, k, v, seg, do, lse_k, delta, scale,
                                                    causal), reps=3, warmup=1)
    torch.cuda.empty_cache()

    # library yardstick (timed only, never called by the port), forward and
    # backward: causal, SDPA on a single-segment batch of the same shape;
    # full, SDPA with the same-segment mask on the same batch
    import torch.nn.functional as F

    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
    lib_kw = dict(is_causal=True) if causal else dict(attn_mask=(seg[:, None, :, None]
                                                                  == seg[:, None, None, :]))

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True, scale=scale, **lib_kw)

    lib_fwd = timed_ms(sdpa)
    lib_out = sdpa()
    dot = do.transpose(1, 2)
    lib_bwd = timed_ms(lambda: torch.autograd.grad(lib_out, (qt, kt, vt), dot, retain_graph=True))
    del lib_out, lib_kw

    bf, f32, i32 = 2, 4, 4
    nq, nkv = b * s * hq * d * bf, b * s * hkv * d * bf
    rows, segb = b * hq * s * f32, b * s * i32
    # operations: 2 products of 2*D FLOPs per visible pair (fwd), 4 (dK/dV:
    # recomputed S, dP, dV, dK), 3 (dQ: S, dP, dQ); bytes: inputs once, outputs once
    fwd_bound = bound_ms(dev, 4 * d * hq * pairs, nq + 2 * nkv + segb + nq + rows)
    dkv_bound = bound_ms(dev, 8 * d * hq * pairs, 2 * nq + 2 * nkv + segb + 2 * rows + 2 * nkv)
    dq_bound = bound_ms(dev, 6 * d * hq * pairs, 2 * nq + 2 * nkv + segb + 2 * rows + nq)
    src = "veomni_tpu_torch/csrc/flash_attention.cu"
    ref = "veomni_tpu/ops/pallas/flash_attention.py"
    held = dict(head_dim=d, layout=f"{tag}: B={b} S={s} Hq={hq} Hkv={hkv} D={d}"
                + ("" if causal else ", full"))
    table = [
        dict(name="flash_fwd", route="cuda", source=src, replaces=f"{ref}:49", **held,
             max_abs_err=max(err_o, err_lse), ms=ms["fwd"], plain_ms=plain_fwd,
             bound_ms=fwd_bound[0], bound_by=fwd_bound[1], library_ms=lib_fwd,
             single_segment_ms=single["fwd"]),
        dict(name="flash_bwd_dkv", route="cuda", source=src, replaces=f"{ref}:155", **held,
             max_abs_err=max(err_dk, err_dv), ms=ms["dkv"], plain_ms=plain_bwd,
             bound_ms=dkv_bound[0], bound_by=dkv_bound[1], library_ms=lib_bwd,
             single_segment_ms=single["dkv"]),
        dict(name="flash_bwd_dq", route="cuda", source=src, replaces=f"{ref}:208", **held,
             max_abs_err=err_dq, ms=ms["dq"], plain_ms=plain_bwd,
             bound_ms=dq_bound[0], bound_by=dq_bound[1], library_ms=lib_bwd,
             single_segment_ms=single["dq"]),
    ]
    for row in table:
        log(f"  {row['name']} ({tag}): {row['ms']:.3f} ms (bound {row['bound_ms']:.3f} ms by "
            f"{row['bound_by']}, plain {row['plain_ms']:.3f} ms, library {row['library_ms']:.3f} ms)")
    full_pairs = b * s * (s + 1) // 2 if causal else b * s * s
    log(f"  flash_fwd ({tag}): {4 * d * hq * pairs / ms['fwd'] / 1e9:.1f} TFLOP/s on the "
        f"visible pairs; on a single-segment batch of the same shape "
        f"{single['fwd']:.3f} ms against SDPA's {lib_fwd:.3f} ms "
        f"({'the same function' if causal else 'masked, on the packed batch'}), "
        f"{4 * d * hq * full_pairs / single['fwd'] / 1e9:.1f} TFLOP/s")
    bwd = ms["dkv"] + ms["dq"]
    bwd1 = single["dkv"] + single["dq"]
    # useful work of a backward: 5 products of 2*D FLOPs per visible pair (S, dP,
    # dV, dK, dQ), as SDPA's backward does them; K2 and K3 each recompute S and dP
    log(f"  flash backward ({tag}): K2 + K3 {bwd:.3f} ms ({ms['dkv']:.3f} + {ms['dq']:.3f}), "
        f"{10 * d * hq * pairs / bwd / 1e9:.1f} TFLOP/s of useful work on the visible pairs; "
        f"on the single-segment batch {bwd1:.3f} ms ({single['dkv']:.3f} + {single['dq']:.3f}) "
        f"against SDPA's backward {lib_bwd:.3f} ms ({bwd1 / lib_bwd:.2f}x"
        f"{'' if causal else '; SDPA masked, on the packed batch'}), "
        f"{10 * d * hq * full_pairs / bwd1 / 1e9:.1f} TFLOP/s of useful work")
    log("  (plain_ms of K2 and K3 is the plain backward computing dQ, dK, dV together; "
        "library_ms of K2 and K3 is SDPA's backward, also all three)")
    return table


def edge_segments(layout: str) -> torch.Tensor:
    """[1, S] segment ids of one K1 edge case (K1's tiles are 128 rows)."""
    if layout == "S=128 one tile":
        return torch.ones(1, 128, dtype=torch.int32)
    if layout == "one segment":
        return torch.ones(1, 512, dtype=torch.int32)
    if layout == "short segments":  # many boundaries inside each 128-row tile
        lengths = torch.tensor([5, 17, 40, 3, 60, 1, 33, 96]).repeat(8)
        return torch.repeat_interleave(torch.arange(1, 65, dtype=torch.int32), lengths)[None, :512]
    if layout == "tile edges":  # boundaries exactly on tile edges
        return torch.tensor([1] * 128 + [2] * 256 + [3] * 128, dtype=torch.int32)[None]
    if layout == "three k tiles":  # S = 384: an odd number of 128-key tiles
        return torch.tensor([1] * 200 + [2] * 184, dtype=torch.int32)[None]
    raise ValueError(layout)


def phase_flash_edges(dev):
    """K1 where its per-tile decisions (skip, mask or not) can break: one
    tile, one segment, segment boundaries inside tiles and on tile edges,
    causal and full, at both head layouts; K2 and K3 through the same
    autograd calls."""
    from veomni_tpu_torch.ops.cuda import flash_attention as fa

    log("flash kernels, edge cases (B=1):")
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(3)
    for layout in ("S=128 one tile", "one segment", "short segments", "tile edges",
                   "three k tiles"):
        seg = edge_segments(layout).to(dev)
        s = seg.shape[1]
        for hq, hkv in ((4, 2), (32, 4)):  # K2 splits the group: 2 and 8 ways
            q = torch.randn(1, s, hq, 128, device=dev, generator=gen).bfloat16()
            k = torch.randn(1, s, hkv, 128, device=dev, generator=gen).bfloat16()
            v = torch.randn(1, s, hkv, 128, device=dev, generator=gen).bfloat16()
            do = torch.randn(1, s, hq, 128, device=dev, generator=gen).bfloat16()
            for causal in (True, False):
                tag = (f"{layout}, S={s} Hq={hq} Hkv={hkv}, {'causal' if causal else 'full'}, "
                       f"K2 split {fa.dkv_group_split(1, s, hq, hkv, n_sm)}")
                qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
                out = fa.flash_attention(qg, kg, vg, segment_ids=seg, causal=causal)
                out.backward(do)
                o_p, lse_p = fa.flash_fwd_plain(q, k, v, seg, 128 ** -0.5, causal)
                o_k, lse_k = fa.flash_fwd_cuda(q, k, v, seg, 128 ** -0.5, causal, fa.seg_ranges(seg))
                check_close(f"K1 O (edge: {tag})", out, o_p)
                check_close(f"K1 LSE (edge: {tag})", lse_k, lse_p, atol=TOL_LSE, rtol=0.0)
                delta = (do.float() * o_k.float()).sum(-1).transpose(1, 2).contiguous()
                refs = fa.flash_bwd_plain(q, k, v, seg, do, lse_k, delta, 128 ** -0.5, causal)
                for name, got, ref in zip(("K3 dQ", "K2 dK", "K2 dV"),
                                          (qg.grad, kg.grad, vg.grad), refs):
                    check_close(f"{name} (edge: {tag})", got, ref)
                check_deterministic(f"edge: {tag}", q, k, v, seg, do, lse_k, delta, 128 ** -0.5,
                                    causal, fa.seg_ranges(seg))
    phase_flash_empty_walk(dev)


def phase_flash_empty_walk(dev):
    """An item whose walk is empty must write zeros, not leave the
    ``torch.empty`` outputs as they were. No caller can reach that state: in
    self-attention every key tile sees its own q tiles, and every q tile its
    own keys. So this check forges it: tokens 128..255 are a segment of their
    own whose blocks' ranges are given as empty (min 100 > max 99), which
    meets no range. Their dK, dV (K2) and dQ (K3) must come out exactly 0
    (against no reference: the true values are not 0); every other token's
    is held to the plain version, which that segment does not touch."""
    from veomni_tpu_torch.ops.cuda import flash_attention as fa

    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(5)
    scale = 128 ** -0.5
    b, hq, hkv = 1, 32, 4
    seg = torch.tensor([[1] * 128 + [7] * 128 + [2] * 256] * b, dtype=torch.int32, device=dev)
    rng = fa.seg_ranges(seg)
    empty = torch.tensor([100, 99], device=dev)  # min > max: meets no range
    rng[:, 128 // fa.SEG_RANGE_BLOCK:256 // fa.SEG_RANGE_BLOCK] = empty
    q, do = (torch.randn(b, 512, hq, 128, device=dev, generator=gen).bfloat16() for _ in range(2))
    k, v = (torch.randn(b, 512, hkv, 128, device=dev, generator=gen).bfloat16() for _ in range(2))
    o, lse = fa.flash_fwd_cuda(q, k, v, seg, scale, True, fa.seg_ranges(seg))
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    dk, dv = fa.flash_bwd_dkv_cuda(q, k, v, seg, do, lse, delta, scale, True, rng)
    dq = fa.flash_bwd_dq_cuda(q, k, v, seg, do, lse, delta, scale, True, rng)
    refs = fa.flash_bwd_plain(q, k, v, seg, do, lse, delta, scale, True)
    tag = (f"forged empty walk of tokens 128..255, B={b} S=512 Hq={hq} Hkv={hkv}, "
           f"K2 split {fa.dkv_group_split(b, 512, hq, hkv, n_sm)}")
    other = torch.cat([torch.arange(128), torch.arange(256, 512)]).to(dev)
    for name, got, ref in zip(("K3 dQ", "K2 dK", "K2 dV"), (dq, dk, dv), refs):
        check_close(f"{name} (edge: {tag}, other tokens)", got[:, other], ref[:, other])
        if got[:, 128:256].any():
            raise AssertionError(f"{name} (edge: {tag}): the tokens of the empty walk are "
                                 f"not all 0")
    log(f"  K3 dQ, K2 dK and dV (edge: {tag}): the empty walk's tokens are exactly 0")


def moe_group_sizes(dev, seq_len: int, micro_bs: int):
    """Rows per expert of the MoE main path's layer 0 on its first packed
    micro-batch: the same seeded weights (layer 0 comes first in the init
    order, so it does not depend on depth) and the same batch, routed
    without gradients."""
    from veomni_tpu_torch.models import Transformer
    from veomni_tpu_torch.train_text_step import SEED, bench_config, packed_batches

    cfg = bench_config(MOE_PRESET, num_hidden_layers=1)
    model = Transformer(cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev)
    batch = {k: torch.from_numpy(v[0]).to(dev)
             for k, v in next(packed_batches(cfg.vocab_size, seq_len, micro_bs)).items()}
    return layer0_expert_counts(model, batch)


def layer0_expert_counts(model, batch):
    """Rows per expert of ``model``'s layer 0 on ``batch`` ([B, S] tensors
    on its device), routed without gradients."""
    from veomni_tpu_torch.models.transformer import expert_counts, route_tokens

    cfg, layer = model.cfg, model.layers[0]
    with torch.no_grad():
        hidden, cos, sin = model.embed_and_rotary(batch["input_ids"], batch["position_ids"])
        q, k, v = layer._qkv(hidden, cos, sin)
        _, x = layer.mlp_input(hidden, layer._attend(q, k, v, batch["segment_ids"]))
        idx, _, _ = route_tokens(x.reshape(-1, cfg.hidden_size), layer.router.to(cfg.dtype), cfg)
        return expert_counts(idx.reshape(-1), cfg.num_experts)


def library_gmm(kind: str, lhs, rhs, g, starts):
    """(ms, name) of one PyTorch call computing what kernel ``kind``
    computes (timed only, never called by the port): ``torch._grouped_mm``
    where this torch has it and takes these layouts, else one
    ``torch.matmul`` of the same M x K x N, named so."""
    offs = starts[1:]
    if hasattr(torch, "_grouped_mm"):
        call = {"fwd": lambda: torch._grouped_mm(lhs, rhs, offs=offs),
                "dlhs": lambda: torch._grouped_mm(g, rhs.transpose(1, 2), offs=offs),
                "t": lambda: torch._grouped_mm(lhs.t(), g, offs=offs)}[kind]
        try:
            call()
            return timed_ms(call), "torch._grouped_mm"
        except RuntimeError as e:  # a yardstick only: say so and time the matmul instead
            log(f"  torch._grouped_mm ({kind}) refused these inputs: {str(e).splitlines()[0]}")
    a, b = {"fwd": (lhs, rhs[0]), "dlhs": (g, rhs[0].t()), "t": (lhs.t(), g)}[kind]
    return timed_ms(lambda: torch.matmul(a, b)), "torch.matmul of the same M x K x N"


def gmm_case(dev, sizes, k: int, n: int, tag: str, timed: bool = False, rows=None):
    """K4, K5, K6 against their plain versions for one set of group sizes,
    through the autograd Function and through each wrapper, over ``rows``
    rows (default: as many as the groups hold; rows past the groups must come
    out of K4 and K5 exactly 0); with ``timed``, also their times, bounds and
    library yardsticks (the table rows)."""
    from veomni_tpu_torch.ops.cuda import grouped_gemm as gg

    sizes = sizes.to(dev)
    e = sizes.numel()
    starts = gg.group_starts(sizes)
    owned = int(starts[-1])
    m = owned if rows is None else rows
    gen = torch.Generator(device=dev).manual_seed(2)
    lhs = torch.randn(m, k, device=dev, generator=gen).bfloat16()
    rhs = torch.randn(e, k, n, device=dev, generator=gen).bfloat16()
    g = torch.randn(m, n, device=dev, generator=gen).bfloat16()

    def hold(name, got, ref):
        err = check_close(f"{name} ({tag})", got, ref,
                          atol=GMM_ATOL_MAX * ref.float().abs().max().item(), rtol=GMM_RTOL)
        if name.startswith("K6") and (sizes == 0).any():  # K6 writes them: torch.empty output
            if got[sizes == 0].any():
                raise AssertionError(f"{name} ({tag}): kernel disagrees with its plain version "
                                     f"(the drhs of an empty expert is not all 0)")
            log(f"  {name} ({tag}): the drhs of each of {int((sizes == 0).sum())} empty "
                f"experts is exactly 0")
        if not name.startswith("K6") and m > owned:  # rows no expert owns
            if got[owned:].any():
                raise AssertionError(f"{name} ({tag}): kernel disagrees with its plain version "
                                     f"(rows {owned}.. past the groups are not all 0)")
            log(f"  {name} ({tag}): rows {owned}..{m - 1} past the groups are exactly 0")
        return err

    lhs_g, rhs_g = lhs.clone().requires_grad_(), rhs.clone().requires_grad_()
    out = gg.cuda_group_gemm(lhs_g, rhs_g, sizes)
    out.backward(g)
    ref = gg.gmm_plain(lhs, rhs, starts)
    err = {"fwd": hold("K4 out (autograd path)", out, ref)}
    hold("K4 out (wrapper)", gg.gmm_cuda(lhs, rhs, starts), ref)
    ref = gg.gmm_dlhs_plain(g, rhs, starts)
    err["dlhs"] = hold("K5 dlhs (autograd path)", lhs_g.grad, ref)
    hold("K5 dlhs (wrapper)", gg.gmm_dlhs_cuda(g, rhs, starts), ref)
    ref = gg.gmm_t_plain(lhs, g, starts, e)
    err["t"] = hold("K6 drhs (autograd path)", rhs_g.grad, ref)
    hold("K6 drhs (wrapper)", gg.gmm_t_cuda(lhs, g, starts, e), ref)
    del ref, lhs_g, rhs_g, out
    torch.cuda.empty_cache()
    if not timed:
        return None

    used = int((sizes > 0).sum())  # experts whose weights this data needs
    bf, i32 = 2, 4
    flops = 2.0 * m * k * n
    kernels = {
        "fwd": ("gmm_fwd", 37, m * k * bf + used * k * n * bf + m * n * bf,
                lambda: gg.gmm_cuda(lhs, rhs, starts), lambda: gg.gmm_plain(lhs, rhs, starts)),
        "dlhs": ("gmm_dlhs", 104, m * n * bf + used * k * n * bf + m * k * bf,
                 lambda: gg.gmm_dlhs_cuda(g, rhs, starts),
                 lambda: gg.gmm_dlhs_plain(g, rhs, starts)),
        "t": ("gmm_t", 166, m * k * bf + m * n * bf + e * k * n * bf,
              lambda: gg.gmm_t_cuda(lhs, g, starts, e),
              lambda: gg.gmm_t_plain(lhs, g, starts, e)),
    }
    rows = []
    for kind, (name, line, nbytes, kernel, plain) in kernels.items():
        lib_ms, lib_name = library_gmm(kind, lhs, rhs, g, starts)
        bound = bound_ms(dev, flops, nbytes + (e + 1) * i32)
        row = dict(name=name, route="cuda", source="veomni_tpu_torch/csrc/grouped_gemm.cu",
                   replaces=f"veomni_tpu/ops/pallas/grouped_gemm.py:{line}", k=k, n=n,
                   layout=f"{tag}: M={m} E={e}",
                   max_abs_err=err[kind], ms=timed_ms(kernel),
                   plain_ms=timed_ms(plain, reps=3, warmup=1),
                   bound_ms=bound[0], bound_by=bound[1], library_ms=lib_ms)
        log(f"  {name} ({tag}): {row['ms']:.3f} ms (bound {row['bound_ms']:.3f} ms by "
            f"{row['bound_by']}, plain {row['plain_ms']:.3f} ms, library {lib_ms:.3f} ms "
            f"[{lib_name}]); {flops / row['ms'] / 1e9:.1f} TFLOP/s")
        rows.append(row)
        torch.cuda.empty_cache()
    return rows


def phase_gmm(dev):
    """K4-K6 on small edge cases, then at the MoE main path's shapes with
    its real routing. Returns the table rows of the gate/up shape; the
    down-projection shape's numbers are printed beside them."""
    sizes = moe_group_sizes(dev, 4096, 4)
    torch.cuda.empty_cache()
    s = sizes.cpu()
    log(f"grouped GEMM kernels: layer-0 routing of the MoE main path's first batch: "
        f"M={int(s.sum())} rows over E={s.numel()} experts, rows/expert min {int(s.min())} "
        f"median {int(s.median())} max {int(s.max())}, empty experts {int((s == 0).sum())}")
    for tag, case in {"ragged+empty": [100, 156, 0, 256], "single": [0, 512, 0, 0],
                      "mid-tile": [37, 0, 219, 64, 192],
                      "unaligned M=420": [37, 0, 219, 64, 100],
                      "M=65 < one tile": [20, 0, 45],
                      # K6's 64-row chunks: experts ending on a chunk edge (64,
                      # 192), shorter than a chunk (40), mid-chunk (100)
                      "chunk edges": [64, 128, 0, 40, 192, 100]}.items():
        gmm_case(dev, torch.tensor(case), 128, 256, f"small {tag}, K=128 N=256")
    gmm_case(dev, torch.tensor([100, 0, 200, 0]), 128, 256,
             "small rows 300..511 past the groups, K=128 N=256", rows=512)
    # E = 128, most experts empty: a boundary on the tile edge at row 128
    # after a run of empty experts, one mid-tile, and the other tile widths
    # (K4 writes 128-column tiles at N = 384, K5 256-column ones at K = 256)
    edge = torch.zeros(128, dtype=torch.int64)
    edge[5], edge[64], edge[127] = 128, 200, 156
    gmm_case(dev, edge, 256, 384, "small E=128 tile-edge, K=256 N=384")
    # K and N multiples of 8 but not of the tiles: the last tiles reach past
    # the tensors' edges (K4's contraction tail, K5's and K6's output tails)
    for tag, case in {"ragged+empty": [100, 156, 0, 256], "unaligned M=420": [37, 0, 219, 64, 100],
                      "chunk edges": [64, 128, 0, 40, 192, 100]}.items():
        gmm_case(dev, torch.tensor(case), 136, 200, f"small {tag}, K=136 N=200")
    gmm_case(dev, torch.tensor([100, 0, 200, 0]), 776, 64,
             "small rows 300..511 past the groups, K=776 N=64", rows=512)
    rows = gmm_case(dev, sizes, 2048, 768, "gate/up: K=2048 N=768", timed=True)
    gmm_case(dev, sizes, 768, 2048, "down: K=768 N=2048", timed=True)
    # the same routing at widths the tiles do not divide: 776 = 6 x 128 + 8
    # (K and N), and the reference CLI config's expert width 64
    # (tests/test_cli_subprocess.py:41), held and timed; no main path runs them
    for k, n, what in ((2048, 776, "gate/up"), (776, 2048, "down"), (2048, 64, "gate/up")):
        for row in gmm_case(dev, sizes, k, n, f"{what} at K={k} N={n}", timed=True):
            row["on_main_path"] = False
            rows.append(row)
    return rows


def reset_all_counts():
    from veomni_tpu_torch.ops.cuda import flash_attention as fa
    from veomni_tpu_torch.ops.cuda import grouped_gemm as gg

    fa.reset_counts()
    gg.reset_counts()


def read_counts():
    """(launches by kernel, flash attention's plain-path dispatches)."""
    from veomni_tpu_torch.ops.cuda import flash_attention as fa
    from veomni_tpu_torch.ops.cuda import grouped_gemm as gg

    return {**fa.LAUNCHES, **gg.LAUNCHES}, {"flash": fa.FALLBACK_CALLS}


def check_steps(records, tag):
    for r in records:
        if not (math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"]) and r["step_ok"]):
            raise AssertionError(f"non-finite {tag} train step: {r}")


def check_counts(launches, fallbacks, want, tag):
    for name, n in launches.items():
        if n != want.get(name, 0):
            raise AssertionError(f"{name}: {n} launches on the {tag} main path, "
                                 f"expected {want.get(name, 0)}")
    if any(fallbacks.values()):
        raise AssertionError(f"FALLBACK_CALLS {fallbacks} on the {tag} main path")


def phase_main(dev, card):
    """The dense main path: Qwen3-0.6B, full depth."""
    from veomni_tpu_torch.train_text_step import run_train_steps

    reset_all_counts()
    records = run_train_steps(4096, 4, MAIN_STEPS, device=dev)
    launches, fallbacks = read_counts()
    for i, r in enumerate(records):
        log(f"main step {i}: loss={r['loss']:.6f} grad_norm={r['grad_norm']:.6f} "
            f"step_ms={r['step_ms']:.1f} tokens_per_s={r['tokens_per_s']:.1f} "
            f"mfu={r['mfu']:.4f} ntokens={int(r['ntokens'])} [{card}]")
    log(f"main path launches: {launches}, FALLBACK_CALLS={fallbacks} "
        f"(Qwen3-0.6B, {LAYERS} layers, seq 4096, micro-batch 4, ctx remat)")
    check_steps(records, "dense")
    per_kernel = LAYERS * MAIN_STEPS  # one micro-batch per step; ctx never reruns K1
    check_counts(launches, fallbacks, {"flash_fwd": per_kernel, "flash_bwd_dkv": per_kernel,
                                       "flash_bwd_dq": per_kernel}, "dense")
    return launches


def phase_moe_main(dev, card):
    """The MoE main path: Qwen3-30B-A3B at full width, MOE_LAYERS deep,
    then the MoE router monitor on its trained model. Returns (the steps'
    launches, the monitor's)."""
    from veomni_tpu_torch.train_text_step import run_train_steps

    torch.cuda.reset_peak_memory_stats(dev)
    reset_all_counts()
    keep = {}
    records = run_train_steps(4096, 4, MAIN_STEPS, preset=MOE_PRESET, num_layers=MOE_LAYERS,
                              device=dev, keep=keep)
    launches, fallbacks = read_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    for i, r in enumerate(records):
        log(f"moe step {i}: loss={r['loss']:.6f} moe_aux_loss={r['moe_aux_loss']:.6f} "
            f"grad_norm={r['grad_norm']:.6f} step_ms={r['step_ms']:.1f} "
            f"tokens_per_s={r['tokens_per_s']:.1f} mfu={r['mfu']:.4f} "
            f"ntokens={int(r['ntokens'])} [{card}]")
    log(f"moe path launches: {launches}, FALLBACK_CALLS={fallbacks}, peak device memory "
        f"{peak / 2**30:.2f} GiB (Qwen3-30B-A3B width, {MOE_LAYERS} layers, seq 4096, "
        f"micro-batch 4, ctx remat)")
    check_steps(records, "MoE")
    n = MOE_LAYERS * MAIN_STEPS
    # per MoE layer and step: K4 runs gate, up and down in the forward and
    # again in the ctx recompute of the post-attention block; backward runs
    # K5 and K6 once per grouped GEMM; the attention forward is not rerun
    check_counts(launches, fallbacks, {"flash_fwd": n, "flash_bwd_dkv": n, "flash_bwd_dq": n,
                                       "gmm_fwd": 6 * n, "gmm_dlhs": 3 * n, "gmm_t": 3 * n},
                 "MoE")
    micro = {k: v[0] for k, v in keep.pop("first_batch").items()}
    monitor = moe_monitor_leg(card, keep.pop("model"), micro)
    return launches, monitor


def moe_monitor_leg(card, model, micro):
    """``utils/moe_monitor.py`` on the MoE phase's model after its steps:
    ``capture_router_stats`` on the first micro-batch (a ``no_grad`` replay:
    K1 once and K4 three times per layer, nothing else), each layer's load
    held to a count of the same micro-batch's routing by this script's own
    f32 router (softmax, then the first top-k of a stable sort, on the
    router inputs the replay saw), and the gauges published. Returns the
    replay's launches."""
    from veomni_tpu_torch.models import transformer
    from veomni_tpu_torch.observability.metrics import get_registry
    from veomni_tpu_torch.utils.moe_monitor import capture_router_stats, publish_router_stats

    cfg = model.cfg
    seen = []
    route = transformer.route_tokens

    def recording_route(x, router, *args, **kwargs):  # the replay's router inputs
        seen.append((x.detach(), router.detach()))
        return route(x, router, *args, **kwargs)

    transformer.route_tokens = recording_route
    try:
        reset_all_counts()
        t0 = time.perf_counter()
        load = capture_router_stats(model, micro)["expert_load"]
        replay_s = time.perf_counter() - t0
        launches, fallbacks = read_counts()
    finally:
        transformer.route_tokens = route
    if load.shape != (MOE_LAYERS, cfg.num_experts) or len(seen) != MOE_LAYERS:
        raise AssertionError(f"moe monitor: expert load {load.shape}, {len(seen)} router calls")
    if not np.allclose(load.sum(1), 1.0, rtol=0, atol=1e-12):
        raise AssertionError(f"moe monitor: load rows sum to {load.sum(1)}")
    own = []
    with torch.no_grad():
        for x, router in seen:
            probs = torch.softmax(x.float() @ router.float(), dim=-1)
            top = torch.sort(probs, dim=-1, descending=True, stable=True).indices
            own.append(torch.bincount(top[:, :cfg.num_experts_per_tok].reshape(-1),
                                      minlength=cfg.num_experts).double().cpu().numpy())
    own = np.stack(own)
    if not np.array_equal(load, own / own.sum(1, keepdims=True)):
        bad = int((load != own / own.sum(1, keepdims=True)).sum())
        raise AssertionError(f"moe monitor: the expert load departs from this script's own "
                             f"routing count in {bad} of {load.size} entries")
    publish_router_stats(load)
    reg = get_registry()
    for li, row in enumerate(load):
        nz = row[row > 0]
        want = {"entropy": float(-(nz * np.log(nz)).sum()), "max_load": float(row.max()),
                "drop_frac": float(np.clip(row - 1.0 / len(row), 0.0, None).sum())}
        got = {k: reg.gauge(f"moe.layer{li}.{k}").value for k in want}
        if got != want:
            raise AssertionError(f"moe monitor: layer {li} gauges {got}, expected {want}")
    check_counts(launches, fallbacks, {"flash_fwd": MOE_LAYERS, "gmm_fwd": 3 * MOE_LAYERS},
                 "MoE monitor replay")
    entropy = [reg.gauge(f"moe.layer{i}.entropy").value for i in range(MOE_LAYERS)]
    log(f"moe monitor (Qwen3-30B-A3B width, {MOE_LAYERS} layers, its model after "
        f"{MAIN_STEPS} steps, the first micro-batch of 4 x 4096): expert load "
        f"{list(load.shape)}, rows sum to 1, equal to this script's own f32 routing count "
        f"({int(own.sum())} assignments); max load per layer "
        f"{', '.join(f'{x:.4f}' for x in load.max(1))} (ideal {1 / cfg.num_experts:.4f}), "
        f"entropy {', '.join(f'{x:.4f}' for x in entropy)} nats (ln {cfg.num_experts} = {math.log(cfg.num_experts):.4f}); gauges published; "
        f"replay {replay_s * 1e3:.1f} ms; launches {launches}, FALLBACK_CALLS={fallbacks} "
        f"[{card}]")
    return launches


def phase_moe_micro_batch_1(dev, card):
    """The MoE main path at micro-batch 1, the micro-batch of the repo's
    Qwen3-30B-A3B config (``configs/text/qwen3_moe_ep.yaml``, seq 4096). One
    row gives K2 128 work items (4 kv heads x 32 key tiles), so
    dkv_group_split splits each group of 8 q heads over 4 items. Legs with
    the split and without it (SPLIT_ITEMS_PER_SM 0: the whole group in every
    item, the TMA-store epilogue) alternate, twice each, every leg a fresh
    model from the same seed on the same batches, so all four do the same
    work; their losses and grad norms must agree step by step. Returns the
    median step_ms of the steps after the first two, by leg."""
    from veomni_tpu_torch.ops.cuda import flash_attention as fa
    from veomni_tpu_torch.train_text_step import run_train_steps

    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    rule = fa.SPLIT_ITEMS_PER_SM
    n = MOE_LAYERS * MB1_STEPS
    legs = {"split": [], "no split": []}
    try:
        for leg in ("split", "no split", "split", "no split"):
            fa.SPLIT_ITEMS_PER_SM = rule if leg == "split" else 0
            split = fa.dkv_group_split(1, 4096, 32, 4, n_sm)
            if (split > 1) != (leg == "split"):
                raise AssertionError(f"moe micro-batch 1 ({leg}): K2 split {split}")
            reset_all_counts()
            records = run_train_steps(4096, 1, MB1_STEPS, preset=MOE_PRESET,
                                      num_layers=MOE_LAYERS, device=dev)
            launches, fallbacks = read_counts()
            torch.cuda.empty_cache()
            for i, r in enumerate(records):
                log(f"moe micro-batch 1 step {i} ({leg}, K2 split {split}): "
                    f"loss={r['loss']:.6f} grad_norm={r['grad_norm']:.6f} "
                    f"step_ms={r['step_ms']:.1f} tokens_per_s={r['tokens_per_s']:.1f} "
                    f"mfu={r['mfu']:.4f} [{card}]")
            check_steps(records, f"MoE micro-batch 1 ({leg})")
            check_counts(launches, fallbacks, {
                "flash_fwd": n, "flash_bwd_dkv": n, "flash_bwd_dq": n,
                "gmm_fwd": 6 * n, "gmm_dlhs": 3 * n, "gmm_t": 3 * n}, f"MoE micro-batch 1 ({leg})")
            legs[leg].append(records)
    finally:
        fa.SPLIT_ITEMS_PER_SM = rule
    base = legs["split"][0]
    for leg, runs in legs.items():
        for records in runs:
            for r, ref in zip(records, base):
                d_loss = abs(r["loss"] - ref["loss"]) / abs(ref["loss"])
                d_gn = abs(r["grad_norm"] - ref["grad_norm"]) / abs(ref["grad_norm"])
                if not (d_loss <= TOL_LOSS_REL and d_gn <= TOL_GRAD_NORM_REL):
                    raise AssertionError(f"moe micro-batch 1 ({leg}) departs from the first "
                                         f"split leg: loss rel {d_loss}, grad_norm rel {d_gn}")
    ms = {leg: sorted(r["step_ms"] for records in runs for r in records[2:])
          for leg, runs in legs.items()}
    med = {leg: v[len(v) // 2] for leg, v in ms.items()}
    log(f"moe micro-batch 1 (Qwen3-30B-A3B width, {MOE_LAYERS} layers, seq 4096, ctx remat): "
        f"steps 2.. with K2's split {', '.join(f'{x:.1f}' for x in ms['split'])} ms, median "
        f"{med['split']:.1f}; without {', '.join(f'{x:.1f}' for x in ms['no split'])} ms, "
        f"median {med['no split']:.1f}; the split saves "
        f"{med['no split'] - med['split']:.1f} ms a step; losses and grad norms of all legs "
        f"agree (rel tol {TOL_LOSS_REL}, {TOL_GRAD_NORM_REL}); launches per leg K1-K3 {n}, "
        f"K4 {6 * n}, K5 {3 * n}, K6 {3 * n}")
    return med


def state_digest(train_state):
    """Per tensor (parameters, then each one's AdamW exp_avg and
    exp_avg_sq; a rank's own part of a sharded one), on the card: the sum of its 32-bit words and their sum
    weighted by a position hash, in int64; plus the update count. Any
    changed word changes the weighted sum."""
    model, opt = train_state.model, train_state.optimizer
    out = []
    with torch.no_grad():
        for _, p in model.named_parameters():
            for t in (p, opt.state[p]["exp_avg"], opt.state[p]["exp_avg_sq"]):
                t = t.to_local() if hasattr(t, "to_local") else t  # a rank's shard
                words = t.detach().contiguous().view(-1).view(torch.int32)
                s1 = torch.zeros((), dtype=torch.int64, device=t.device)
                s2 = torch.zeros((), dtype=torch.int64, device=t.device)
                for lo in range(0, words.numel(), 1 << 24):
                    w = words[lo:lo + (1 << 24)].long()
                    pos = torch.arange(lo, lo + w.numel(), device=t.device, dtype=torch.int64)
                    s1 += w.sum()
                    s2 += (w * ((pos * 2654435761) % 2147483647 + 1)).sum()
                out.append((int(s1), int(s2)))
    out.append(opt.num_updates)
    return out


# the trainer phase's observatories (slice E): the numerics sibling every 2
# steps, the exporter on an ephemeral port, fleet heartbeats
OBSERVATORY_FLAGS = ("--train.observability_numerics_interval=2",
                     "--train.observability_port=-1", "--train.observability_fleet=1")
SCRAPE_AT = 3
EXPORTER_ROUTES = ("/metrics", "/healthz", "/debug/flight?n=50", "/debug/requests",
                   "/debug/memory?k=5", "/debug/cost", "/debug/numerics", "/debug/fleet",
                   "/debug/router")
# the cost census's train.mfu_pct over the meter's FlopsCounter MFU on a hot
# step. The census counts what ran: with ctx remat the backward reruns every
# layer's projections and MLP, and the chunked loss reruns the LM head (+1192
# MFLOPs a token at Qwen3-0.6B over 3 x 1192 for forward and backward); it
# counts attention as the kernels' visible pairs (18 x D x Hq a pair: K1 4,
# K2 8, K3 6), ~550-700 a token on the corpus's 256-2048-token documents,
# where the meter counts the full causal window, S / 2 = 2048 a token, at
# 3 x 4 x D x Hq: 4768 + 568-723 against 4985 MFLOPs a token, 1.07-1.10.
# The two windows are the same step's wall. Band reckoned before the run:
MFU_BAND = (1.0, 1.2)
OOM_BYTES = 1 << 42  # 4 TiB: the allocator refuses it at once


def scrape_routes(port, routes):
    """GET each route on localhost: {route: (status, body bytes)}."""
    import urllib.error
    import urllib.request

    out = {}
    for route in routes:
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{port}{route}", timeout=30) as r:
                out[route] = (r.status, r.read())
        except urllib.error.HTTPError as e:
            out[route] = (e.code, e.read())
    return out


def make_observer():
    """A callback that watches the observatories while the trainer phase's
    leg A trains: each step's heartbeat, the census and meter MFU of each
    synced step, every exporter route scraped once over HTTP at step
    SCRAPE_AT."""
    from veomni_tpu_torch.trainer.callbacks import Callback

    class Observe(Callback):
        def __init__(self):
            self.heartbeats, self.mfu, self.scrapes = {}, {}, {}

        def on_step_end(self, trainer, state):
            path = os.path.join(trainer.args.train.output_dir, "heartbeat-0.json")
            if os.path.exists(path):
                with open(path) as f:
                    self.heartbeats[state.global_step] = json.load(f)["global_step"]
            if state.synced and "mfu_pct" in state.metrics:
                self.mfu[state.global_step] = (state.metrics["mfu_pct"],
                                               state.metrics.get("mfu", 0.0))
            if state.global_step == SCRAPE_AT:
                port = next(cb.exporter.port for cb in trainer.callbacks
                            if getattr(cb, "exporter", None) is not None)
                self.scrapes = scrape_routes(port, EXPORTER_ROUTES)

    return Observe()


def observatory_checks(dev, card, trainer, observe, first_batch):
    """Slice E's checks on the trainer phase's leg A (its trainer, already
    trained): the exporter's routes, the heartbeats, the numerics history,
    the census against the meter and the hand kernels' reports; then, on
    the same trainer, a ``step.params`` nan drill (the provenance names the
    poisoned group and layer) and an out-of-memory drill (the post-mortem
    holds the buffer census)."""
    from veomni_tpu_torch.observability.cost import get_cost_census
    from veomni_tpu_torch.resilience import AnomalyBudgetExceeded
    from veomni_tpu_torch.resilience.faults import configure_faults, disarm_faults
    from veomni_tpu_torch.trainer.callbacks import Callback

    checks = []
    docs = {}
    for route, (status, body) in observe.scrapes.items():
        log(f"trainer exporter: GET {route}: {status}, {len(body)} bytes")
        if route != "/metrics" and status == 200:
            docs[route.split("?")[0]] = json.loads(body)
    checks.append(("exporter routes", len(observe.scrapes) == len(EXPORTER_ROUTES) and all(
        status == 200 for status, _ in observe.scrapes.values()),
        f"{ {r: st for r, (st, _) in observe.scrapes.items()} }"))
    metrics = observe.scrapes.get("/metrics", (0, b""))[1]
    census_doc = docs.get("/debug/memory", {}).get("buffer_census", {})
    checks += [
        ("/metrics", b"veomni_train_loss" in metrics and b"veomni_numerics_" in metrics,
         "train.* and numerics.* families rendered"),
        ("/healthz", docs.get("/healthz", {}).get("healthy") is True, str(docs.get("/healthz"))),
        ("/debug/numerics", docs.get("/debug/numerics", {}).get("observed_steps") == 1,
         "the step-2 summary in the history at step 3"),
        ("/debug/fleet", docs.get("/debug/fleet", {}).get("heartbeats", [{}])[0].get(
            "global_step") == SCRAPE_AT, str(docs.get("/debug/fleet", {}).get("heartbeats"))),
        ("/debug/memory", census_doc.get("total_bytes", 0) > 4 * 596e6,
         f"{census_doc.get('num_arrays')} storages, {census_doc.get('total_bytes', 0) / 2**30:.2f}"
         f" GiB (at least the f32 parameters)"),
        ("/debug/cost", any(p["site"] == "train_step" for p in docs.get(
            "/debug/cost", {}).get("programs", [])), "the train step's bucket"),
    ]
    steps = sorted(observe.heartbeats)
    checks.append(("heartbeat", steps and [observe.heartbeats[i] for i in steps] == steps,
                   f"heartbeat-0.json's step after each step: {observe.heartbeats}"))
    hist = trainer._numerics.snapshot()["history"]
    first_doc = hist[0]["groups"] if hist else {}
    bad = {g: st for g, st in first_doc.items()
           if max(st["grad_nonfinite"] if isinstance(st["grad_nonfinite"], list)
                  else [st["grad_nonfinite"]]) > 0}
    log(f"trainer numerics: {len(first_doc)} groups; step 2 layers.q_proj grad_rms per layer "
        f"{[f'{v:.3e}' for v in first_doc.get('layers.q_proj', {}).get('grad_rms', [])[:4]]}..., "
        f"update_ratio max {max(first_doc.get('layers.q_proj', {}).get('update_ratio', [0])):.3e}")
    checks.append(("numerics history", [h["step"] for h in hist] == [2, 4, 6] and not bad
                   and len(first_doc.get("layers.q_proj", {}).get("grad_rms", [])) == LAYERS,
                   f"steps {[h['step'] for h in hist]}, non-finite groups {sorted(bad)}"))
    # the census: the train step's bucket, its hand-kernel share reckoned by
    # this script's own pair count, not the port's
    rec = get_cost_census().latest("train_step")
    seg = torch.from_numpy(first_batch["segment_ids"][0])
    pairs = visible_pairs(seg)
    want_kernel = LAYERS * 18 * 128 * 16 * pairs
    log(f"trainer cost census: train_step/{rec.bucket} {rec.flops / 1e12:.3f} TFLOPs "
        f"({rec.kernel_flops / 1e12:.3f} from K1-K3), {rec.bytes_accessed / 1e9:.1f} GB accessed, "
        f"temp {'unknown' if rec.temp_bytes is None else f'{rec.temp_bytes / 2**30:.2f} GiB'}, "
        f"counting pass {rec.compile_time_s:.2f} s, calls "
        f"{rec.calls}, {rec.bound()}-bound; {pairs} visible pairs "
        f"({pairs / seg.numel():.1f} a token) [{card}]")
    checks.append(("census kernel FLOPs", rec.kernel_flops == want_kernel,
                   f"{rec.kernel_flops:.6g} against {LAYERS} x 18 x D x Hq x pairs = "
                   f"{want_kernel:.6g}"))
    ratios = {i: c / m for i, (c, m) in observe.mfu.items() if i % 2 == 1 and i > 1 and m}
    log(f"trainer MFU: census train.mfu_pct / meter mfu at the hot steps {ratios} (per step "
        f"(census, meter): { {i: (round(c, 3), round(m, 3)) for i, (c, m) in observe.mfu.items()} }"
        f") [{card}]")
    checks.append(("census MFU band", ratios and all(
        MFU_BAND[0] <= r <= MFU_BAND[1] for r in ratios.values()),
        f"ratios {ratios} within {MFU_BAND}"))
    log_checks("trainer observatories", checks)

    # the nan drill: layer 0 of layers.q_proj poisoned before the next step
    out = trainer.args.train.output_dir
    trainer.args.train.resilience_anomaly_budget = 1
    trainer.train_steps = 2
    reset_all_counts()
    configure_faults([{"point": "step.params", "mode": "nan", "hit": 1,
                       "group": "layers.q_proj"}])
    try:
        trainer.train()
        aborted = False
    except AnomalyBudgetExceeded:
        aborted = True
    finally:
        disarm_faults()
    launches, _ = read_counts()
    prov = trainer._numerics.snapshot()["provenance"] or {}
    first = prov.get("first_nonfinite")
    want = {"group": "layers.q_proj", "kind": "param", "nonfinite_count": 1.0, "layer": 0}
    log(f"trainer nan drill: aborted {aborted}; first_nonfinite {first}; launches {launches}")
    checks = [("nan drill provenance", first == want, f"{first} against {want}")]
    # the out-of-memory drill: a 4 TiB allocation at the next step's begin
    class Oom(Callback):
        def on_step_begin(self, trainer, state):
            torch.empty(OOM_BYTES, dtype=torch.uint8, device=dev)

    trainer.callbacks.append(Oom())
    t0 = time.perf_counter()
    try:
        trainer.train()
        raised = False
    except torch.cuda.OutOfMemoryError:
        raised = True
    trainer.callbacks.pop()
    with open(os.path.join(out, "postmortem-0.json")) as f:
        pm = json.load(f)
    census = pm.get("buffer_census", {})
    log(f"trainer oom drill: raised {raised}; post-mortem {pm.get('reason')} in "
        f"{time.perf_counter() - t0:.2f} s with a buffer census of {census.get('num_arrays')} "
        f"storages, {census.get('total_bytes', 0) / 2**30:.2f} GiB, top "
        f"{[(g['shape'], g['dtype']) for g in census.get('top', [])[:3]]}")
    checks.append(("oom drill post-mortem", raised and pm.get("reason")
                   == "exception:OutOfMemoryError" and census.get("total_bytes", 0) > 4 * 596e6
                   and "cost_census" in pm, f"reason {pm.get('reason')}"))
    log_checks("trainer drills", checks)


def phase_trainer(dev, card):
    """The trainer path: see phase 8 of the module docstring. Returns the
    straight leg's launch counts."""
    from veomni_tpu_torch.arguments import VeOmniArguments, parse_args
    from veomni_tpu_torch.models import Transformer
    from veomni_tpu_torch.observability.cost import get_cost_census
    from veomni_tpu_torch.observability.metrics import get_registry
    from veomni_tpu_torch.optim import build_lr_scheduler, build_optimizer
    from veomni_tpu_torch.parallel.parallel_state import destroy_parallel_state
    from veomni_tpu_torch.tasks.train_text import main as train_text_main
    from veomni_tpu_torch.tools.trainer_profile import SEED as TRAINER_SEED
    from veomni_tpu_torch.tools.trainer_profile import STEPS as TRAINER_STEPS
    from veomni_tpu_torch.tools.trainer_profile import write_config
    from veomni_tpu_torch.train import build_train_state, build_train_step
    from veomni_tpu_torch.train_text_step import bench_config
    from veomni_tpu_torch.trainer import TextTrainer
    from veomni_tpu_torch.trainer.callbacks import Callback, CheckpointCallback

    class Record(Callback):
        """Per synced step: loss, grad norm, valid tokens, host time; the
        first batch as the loop shipped it."""

        def __init__(self, stop_at=None):
            self.steps, self.first_batch, self.stop_at = {}, None, stop_at

        def on_step_begin(self, trainer, state):
            if self.first_batch is None:
                self.first_batch = {k: v.copy() for k, v in trainer.current_batch.items()}

        def on_step_end(self, trainer, state):
            m = state.metrics
            self.steps[state.global_step] = dict(
                loss=m["loss"], grad_norm=m["grad_norm"], ntokens=m["ntokens"],
                t=time.perf_counter())
            if self.stop_at is not None and state.global_step >= self.stop_at:
                state.should_stop = True

    reg = get_registry()

    def span_sum(name):
        return reg.histogram_sum(f"span.{name}")

    tmp = tempfile.mkdtemp(prefix="chip_smoke_trainer_")
    was_deterministic = torch.are_deterministic_algorithms_enabled()
    try:
        cfg_path = write_config(tmp)
        log(f"trainer: a corpus of 512 documents (lengths uniform in [256, 2048], tokens "
            f"uniform over 151936) and the config {cfg_path} (tools/trainer_profile.py)")

        # leg A: six straight steps of TextTrainer from the parsed YAML, with
        # the numerics observatory every 2 steps, the exporter and the fleet
        args = parse_args(VeOmniArguments, [cfg_path, f"--train.output_dir={tmp}/a",
                                            *OBSERVATORY_FLAGS])
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_all_counts()
        get_cost_census().reset()
        trainer = TextTrainer(args)
        # its final checkpoint (7 GB, ~17 s) is never read: leg B's are
        trainer.callbacks = [cb for cb in trainer.callbacks
                             if not isinstance(cb, CheckpointCallback)]
        rec_a = Record()
        observe = make_observer()
        trainer.callbacks += [rec_a, observe]
        trainer.train()
        trainer.checkpointer.close()
        launches, fallbacks = read_counts()
        peak = torch.cuda.max_memory_allocated(dev)
        digest_a = state_digest(trainer.train_state)
        if not torch.are_deterministic_algorithms_enabled():
            raise AssertionError("trainer: enable_full_determinism did not turn on "
                                 "torch.use_deterministic_algorithms")
        a = rec_a.steps
        first_batch = rec_a.first_batch
        ms = [(a[i]["t"] - a[i - 1]["t"]) * 1e3 for i in range(2, TRAINER_STEPS + 1)]
        for i in range(1, TRAINER_STEPS + 1):
            r = a[i]
            extra = (f" step_ms={ms[i - 2]:.1f} "
                     f"valid_tokens_per_s={r['ntokens'] / ms[i - 2] * 1e3:.1f}"
                     if i >= 2 else " (first step: warm-up and the train step's census "
                     "counting pass, not timed)")
            if i % 2 == 0:
                extra += (" (numerics sibling" + ("; its census counting pass)" if i == 2
                                                  else ")"))
            log(f"trainer step {i} (leg A): loss={r['loss']:.6f} grad_norm={r['grad_norm']:.6f} "
                f"ntokens={int(r['ntokens'])}{extra} [{card}]")
        med = sorted(ms)[len(ms) // 2]
        log(f"trainer (Qwen3-0.6B, 28 layers, seq 4096, micro-batch 4, ctx remat, "
            f"deterministic algorithms): warm steps 2-{TRAINER_STEPS} "
            f"{', '.join(f'{x:.1f}' for x in ms)} ms, median {med:.1f} ms, "
            f"{4 * 4096 / med * 1e3:.1f} tokens/s (packed rows, padding included), peak device "
            f"memory {peak / 2**30:.2f} GiB; launches {launches}, FALLBACK_CALLS={fallbacks} "
            f"[{card}]")
        check_steps([dict(loss=r["loss"], grad_norm=r["grad_norm"], step_ok=True)
                     for r in a.values()], "trainer")
        n = LAYERS * TRAINER_STEPS
        check_counts(launches, fallbacks, {"flash_fwd": n, "flash_bwd_dkv": n,
                                           "flash_bwd_dq": n}, "trainer")
        # the drills below train leg A's trainer on: its records stop here
        trainer.callbacks = [cb for cb in trainer.callbacks if cb not in (rec_a, observe)]
        observatory_checks(dev, card, trainer, observe, first_batch)
        shutil.rmtree(os.path.join(tmp, "a"), ignore_errors=True)
        del trainer
        destroy_parallel_state()
        torch.cuda.empty_cache()

        # step-1 parity: train_text_step's build_train_step on the same
        # initial weights (same seed, same init) and the trainer's first batch
        cfg = bench_config("qwen3_0p6b")
        model = Transformer(cfg, torch.Generator(device=dev).manual_seed(TRAINER_SEED), device=dev)
        state = build_train_state(model, build_optimizer(
            model, lr=build_lr_scheduler(lr=1e-4, train_steps=TRAINER_STEPS)))
        batch = {k: torch.from_numpy(v).to(dev) for k, v in first_batch.items()}
        _, m = build_train_step(Transformer.loss_fn)(state, batch)
        bench_loss = float(m["loss"])
        rel = abs(a[1]["loss"] - bench_loss) / abs(bench_loss)
        log(f"trainer step-1 parity: trainer loss {a[1]['loss']:.6f}, train_text_step's "
            f"build_train_step {bench_loss:.6f} (rel {rel:.2e}, tol {TOL_LOSS_REL})")
        if not rel <= TOL_LOSS_REL:
            raise AssertionError(f"trainer step-1 loss departs from build_train_step's ({rel})")
        del model, state, batch, m
        torch.cuda.empty_cache()

        # leg B1: three steps and a checkpoint (save_steps), stopped there
        args = parse_args(VeOmniArguments, [cfg_path, f"--train.output_dir={tmp}/b",
                                            f"--train.save_steps={TRAINER_SAVE_AT}",
                                            *OBSERVATORY_FLAGS])
        reset_all_counts()
        save0, wait0 = span_sum("ckpt.save"), span_sum("ckpt.wait")
        trainer = TextTrainer(args)
        rec_b1 = Record(stop_at=TRAINER_SAVE_AT)
        trainer.callbacks.append(rec_b1)
        trainer.train()
        trainer.checkpointer.close()
        save_s, wait_s = span_sum("ckpt.save") - save0, span_sum("ckpt.wait") - wait0
        b1_launches, b1_fallbacks = read_counts()
        step_dir = os.path.join(tmp, "b", "checkpoints", f"global_step_{TRAINER_SAVE_AT}")
        ckpt_bytes = sum(os.path.getsize(os.path.join(d, f))
                         for d, _, files in os.walk(step_dir) for f in files)
        del trainer
        destroy_parallel_state()
        torch.cuda.empty_cache()

        # leg B2: a fresh main() that auto-resumes from step 3 and runs to 6
        reset_all_counts()
        restore0 = span_sum("ckpt.restore")
        t0 = time.perf_counter()
        trainer = train_text_main([cfg_path, f"--train.output_dir={tmp}/b",
                                   f"--train.save_steps={TRAINER_SAVE_AT}", *OBSERVATORY_FLAGS])
        trainer.checkpointer.close()
        b2_s = time.perf_counter() - t0
        restore_s = span_sum("ckpt.restore") - restore0
        b2_launches, b2_fallbacks = read_counts()
        digest_b = state_digest(trainer.train_state)
        b = {}
        with open(os.path.join(tmp, "b", "metrics_rank0.jsonl")) as f:
            for line in f:
                doc = json.loads(line)
                if "loss" in doc:
                    b[doc["step"]] = doc["loss"]
        del trainer
        destroy_parallel_state()
        torch.cuda.empty_cache()

        log(f"trainer checkpoint (step {TRAINER_SAVE_AT}, async save, size-mode manifest): "
            f"{ckpt_bytes / 1e9:.3f} GB on disk; save {save_s + wait_s:.2f} s "
            f"({save_s:.2f} s blocking the loop: host snapshot + dispatch; {wait_s:.2f} s "
            f"waiting for the write and the manifest at train end); restore {restore_s:.2f} s "
            f"(read + copy into the live model and AdamW); leg B2 {b2_s:.1f} s in all [{card}]")
        for i in range(1, TRAINER_STEPS + 1):
            got = rec_b1.steps[i]["loss"] if i <= TRAINER_SAVE_AT else b.get(i)
            log(f"trainer step {i}: leg A loss {a[i]['loss']!r}, "
                f"{'leg B1' if i <= TRAINER_SAVE_AT else 'leg B2 (resumed)'} loss {got!r}")
            if got != a[i]["loss"]:
                raise AssertionError(f"trainer resume: step {i} loss {got!r} != the straight "
                                     f"leg's {a[i]['loss']!r}")
        if digest_b != digest_a:
            bad = sum(x != y for x, y in zip(digest_a, digest_b))
            raise AssertionError(f"trainer resume: the final state differs from the straight "
                                 f"leg's in {bad} of {len(digest_a)} digest entries "
                                 f"(num_updates {digest_b[-1]} vs {digest_a[-1]})")
        log(f"trainer resume: losses of steps {TRAINER_SAVE_AT + 1}-{TRAINER_STEPS} and the final "
            f"parameters, AdamW moments and num_updates ({digest_a[-1]}) equal the straight "
            f"leg's bit for bit ({len(digest_a) - 1} tensors), the numerics sibling on steps "
            f"2, 4 and 6 of both legs")
        half = LAYERS * TRAINER_SAVE_AT
        for tag, got_l, got_f in (("trainer leg B1", b1_launches, b1_fallbacks),
                                  ("trainer leg B2", b2_launches, b2_fallbacks)):
            check_counts(got_l, got_f, {"flash_fwd": half, "flash_bwd_dkv": half,
                                        "flash_bwd_dq": half}, tag)
        return launches
    finally:
        torch.use_deterministic_algorithms(was_deterministic)
        shutil.rmtree(tmp, ignore_errors=True)


HF_YAML = """
model:
  config_path: {hf}
  model_path: {hf}
data:
  train_path: {data}
  dataset_type: streaming
  data_type: pretokenized
  max_seq_len: {seq}
  dyn_bsz: true
train:
  micro_batch_size: {micro_bs}
  train_steps: {steps}
  bf16: true
  param_dtype: float32
  enable_gradient_checkpointing: true
  gradient_checkpointing_policy: ctx
  lr: 1.0e-4
  lr_decay_style: cosine
  enable_full_determinism: true
  seed: 0
  save_hf_weights: true
  prefetch_depth: 2
  log_steps: 1
"""


def write_hf_run(tmp: str) -> str:
    """The HF phase's inputs under ``tmp``: the corpus (HF_DOCS pretokenized
    documents, lengths uniform in [256, 2048], tokens uniform over
    TinyLlama's 32000, from seed 0) as 4 jsonl shards, and the YAML; returns
    the YAML's path. The HF directory itself is written by phase_hf_trainer."""
    import numpy as np

    rng = np.random.default_rng(0)
    data = os.path.join(tmp, "shards")
    os.makedirs(data)
    for shard in range(4):
        with open(os.path.join(data, f"shard-{shard:03d}.jsonl"), "w") as f:
            for _ in range(HF_DOCS // 4):
                n = int(rng.integers(256, 2049))
                f.write(json.dumps({"input_ids": rng.integers(0, 32000, n).tolist()}) + "\n")
    path = os.path.join(tmp, "tinyllama_hf.yaml")
    with open(path, "w") as f:
        f.write(HF_YAML.format(hf=os.path.join(tmp, "hf"), data=data, seq=HF_SEQ,
                               micro_bs=HF_MICRO_BS, steps=HF_STEPS))
    return path


def hf_first_batch(yaml_path: str):
    """The first packed micro-batch the HF phase's trainer trains on, built
    by the same pieces the trainer builds (streaming shards, pretokenized
    transform, packing collator, token-budget dynamic batching), as numpy
    [1, B, S] arrays; phase_hf_trainer checks the trainer's against it."""
    from veomni_tpu_torch.arguments import VeOmniArguments, parse_args
    from veomni_tpu_torch.data.data_collator import TextPackingCollator
    from veomni_tpu_torch.data.data_transform import build_data_transform
    from veomni_tpu_torch.data.dataset import build_dataset
    from veomni_tpu_torch.data.dynamic_batching import DynamicBatchDataloader

    args = parse_args(VeOmniArguments, [yaml_path])
    d, t = args.data, args.train
    transform = build_data_transform(d.data_type, tokenizer=None, text_keys=d.text_keys,
                                     max_seq_len=d.max_seq_len, channel_list=d.channel_list,
                                     chat_template=d.chat_template)
    ds = build_dataset(d.dataset_type, path=d.train_path, transform=transform,
                       skip_budget=t.data_skip_budget)
    collator = TextPackingCollator(seq_len=d.max_seq_len, micro_batch_size=t.micro_batch_size)
    loader = DynamicBatchDataloader(ds, collator, token_budget=t.micro_batch_size * d.max_seq_len,
                                    grad_accum_steps=args.compute_grad_accum(1),
                                    buffer_size=d.dyn_bsz_buffer_size, seed=t.seed)
    return next(iter(loader))


def phase_hf_trainer(dev, card, yaml_path: str, first_batch):
    """The HF-directory trainer path: see phase 9 of the module docstring.
    Returns leg A's launch counts."""
    from veomni_tpu_torch.arguments import VeOmniArguments, parse_args
    from veomni_tpu_torch.models import Transformer, TransformerConfig
    from veomni_tpu_torch.models.auto import build_foundation_model
    from veomni_tpu_torch.models.hf_io import INDEX_NAME, hf_to_params, save_hf_checkpoint
    from veomni_tpu_torch.ops.cuda import flash_attention as fa
    from veomni_tpu_torch.optim import build_lr_scheduler, build_optimizer
    from veomni_tpu_torch.parallel.parallel_state import destroy_parallel_state
    from veomni_tpu_torch.train import build_train_state, build_train_step
    from veomni_tpu_torch.train_text_step import HF_CONFIGS
    from veomni_tpu_torch.trainer import TextTrainer
    from veomni_tpu_torch.trainer.callbacks import Callback, CheckpointCallback

    class Record(Callback):
        """Per step: loss, grad norm, valid tokens, host time; the first
        batch as the loop shipped it."""

        def __init__(self):
            self.steps, self.first_batch = {}, None

        def on_step_begin(self, trainer, state):
            if self.first_batch is None:
                self.first_batch = {k: v.copy() for k, v in trainer.current_batch.items()}

        def on_step_end(self, trainer, state):
            m = state.metrics
            self.steps[state.global_step] = dict(loss=m["loss"], grad_norm=m["grad_norm"],
                                                 ntokens=m["ntokens"], t=time.perf_counter())

    def leg(out_dir, *overrides):
        args = parse_args(VeOmniArguments, [yaml_path, f"--train.output_dir={out_dir}",
                                            *overrides])
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_all_counts()
        trainer = TextTrainer(args)
        # no final checkpoint (13 GB of f32 state, ~30 s): no check reads it
        trainer.callbacks = [cb for cb in trainer.callbacks
                             if not isinstance(cb, CheckpointCallback)]
        rec = Record()
        trainer.callbacks.append(rec)
        export = {}
        save_hf = trainer.model.save_hf

        def timed_save_hf(*a, **k):  # HFCheckpointCallback's export, timed
            t0 = time.perf_counter()
            save_hf(*a, **k)
            export["s"] = time.perf_counter() - t0

        trainer.model.save_hf = timed_save_hf
        trainer.train()
        trainer.checkpointer.close()
        del trainer.model.save_hf  # the wrapper's cycle would keep the model alive
        launches, fallbacks = read_counts()
        by_dim = {d: dict(c) for d, c in fa.LAUNCHES_BY_HEAD_DIM.items()}
        peak = torch.cuda.max_memory_allocated(dev)
        return trainer, rec, launches, fallbacks, by_dim, peak, export.get("s")

    def params_equal(got, want, what):
        bad = [n for (n, a), (_, b) in zip(got.named_parameters(), want.named_parameters())
               if not torch.equal(a.float(), b.float())]
        if bad:
            raise AssertionError(f"hf trainer: {what} differ from the written ones in "
                                 f"{len(bad)} tensors, e.g. {bad[:3]}")

    tmp = os.path.dirname(yaml_path)
    hf_dir = os.path.join(tmp, "hf")
    was_deterministic = torch.are_deterministic_algorithms_enabled()
    try:
        # random bf16 weights from seed 0, written by the port's own export in
        # HF_SHARD_BYTES shards; config.json is the published one
        published = dict(HF_CONFIGS[HF_PRESET], num_hidden_layers=HF_LAYERS)
        cfg = TransformerConfig.from_hf_config(published, param_dtype=torch.bfloat16)
        written = Transformer(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
        t0 = time.perf_counter()
        save_hf_checkpoint(written, cfg, hf_dir, max_shard_bytes=HF_SHARD_BYTES)
        write_s = time.perf_counter() - t0
        with open(os.path.join(hf_dir, "config.json"), "w") as f:
            json.dump(published, f, indent=2)
        shards = sorted(f for f in os.listdir(hf_dir) if f.endswith(".safetensors"))
        hf_bytes = sum(os.path.getsize(os.path.join(hf_dir, f)) for f in shards)
        if len(shards) < 2 or not os.path.exists(os.path.join(hf_dir, INDEX_NAME)):
            raise AssertionError(f"hf trainer: the written checkpoint has shards {shards}")
        t0 = time.perf_counter()
        loaded = build_foundation_model(hf_dir, weights_path=hf_dir, device=dev).module
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        params_equal(loaded, written, "loaded parameters")
        n_params = sum(p.numel() for p in loaded.parameters())
        log(f"hf trainer: TinyLlama-1.1B ({cfg.num_hidden_layers} layers, hidden "
            f"{cfg.hidden_size}, heads {cfg.num_attention_heads}/{cfg.num_key_value_heads}, "
            f"head dim {cfg.head_dim}, {n_params} parameters) written as random bf16 weights "
            f"(seed 0) in {len(shards)} shards ({hf_bytes / 1e9:.3f} GB, index "
            f"{INDEX_NAME}) in {write_s:.2f} s; loaded by build_foundation_model(config_path, "
            f"weights_path) onto the card in {load_s:.2f} s as f32: the loaded parameters "
            f"are bit-equal to the written ones [{card}]")
        if cfg.head_dim != 64:
            raise AssertionError(f"hf trainer: head dim {cfg.head_dim}, expected 64")
        del loaded, written
        torch.cuda.empty_cache()

        # leg A: the YAML as it is (streaming, dyn_bsz, prefetch 2, HF export)
        trainer, rec_a, launches, fallbacks, by_dim, peak, export_s = leg(os.path.join(tmp, "a"))
        a = rec_a.steps
        shapes = {k: v.shape for k, v in rec_a.first_batch.items()}
        for k in ("input_ids", "segment_ids", "position_ids", "labels"):
            if not (rec_a.first_batch[k] == first_batch[k]).all():
                raise AssertionError(f"hf trainer: the trainer's first batch ({k}) is not the "
                                     f"one the D=64 kernel gates held")
        seq = shapes["input_ids"][-1]
        log(f"hf trainer: dyn_bsz batches are {shapes['input_ids']} (seq {seq}"
            f"{'' if seq % 128 == 0 else ', NOT a multiple of 128'}); the first is the one the "
            f"D=64 kernel gates held")
        ms = [(a[i]["t"] - a[i - 1]["t"]) * 1e3 for i in range(2, HF_STEPS + 1)]
        for i in range(1, HF_STEPS + 1):
            extra = (f" step_ms={ms[i - 2]:.1f} valid_tokens_per_s="
                     f"{float(a[i]['ntokens']) / ms[i - 2] * 1e3:.1f}"
                     if i >= 2 else " (first step: warm-up, not timed)")
            log(f"hf trainer step {i} (leg A, prefetch 2): loss={float(a[i]['loss']):.6f} "
                f"grad_norm={float(a[i]['grad_norm']):.6f} ntokens={int(a[i]['ntokens'])}"
                f"{extra} [{card}]")
        check_steps([dict(loss=float(r["loss"]), grad_norm=float(r["grad_norm"]), step_ok=True)
                     for r in a.values()], "hf trainer")
        n = cfg.num_hidden_layers * HF_STEPS
        check_counts(launches, fallbacks, {"flash_fwd": n, "flash_bwd_dkv": n,
                                           "flash_bwd_dq": n}, "hf trainer")
        if any(by_dim[d][k] != (n if d == 64 else 0) for d in by_dim for k in by_dim[d]):
            raise AssertionError(f"hf trainer: launches by head dim {by_dim}, expected "
                                 f"{n} of each at D=64")
        med = sorted(ms)[len(ms) // 2]
        log(f"hf trainer (TinyLlama-1.1B, {cfg.num_hidden_layers} layers, seq {HF_SEQ}, micro-batch {HF_MICRO_BS}, "
            f"dyn_bsz, streaming jsonl shards, prefetch 2, ctx remat, deterministic algorithms): "
            f"warm steps 2-{HF_STEPS} {', '.join(f'{x:.1f}' for x in ms)} ms, median {med:.1f} "
            f"ms, {HF_MICRO_BS * HF_SEQ / med * 1e3:.1f} tokens/s (packed rows, padding "
            f"included), peak device memory {peak / 2**30:.2f} GiB; HF export (f32) "
            f"{export_s:.2f} s; launches {launches} (all at D=64), FALLBACK_CALLS={fallbacks} "
            f"[{card}]")

        # the export reads back bit-equal to the final parameters
        out = os.path.join(tmp, "a", "hf_ckpt")
        final = trainer.train_state.model
        back = hf_to_params(out, final.cfg, Transformer(final.cfg, None, device=dev))
        params_equal(back, final, "exported parameters read back")
        export_bytes = sum(os.path.getsize(os.path.join(out, f)) for f in os.listdir(out))
        log(f"hf trainer: the HF export ({export_bytes / 1e9:.3f} GB) reads back bit-equal to "
            f"the final parameters")
        del trainer, final, back
        destroy_parallel_state()
        torch.cuda.empty_cache()

        # step-1 parity: the bare build_train_step on the same weights and batch
        model = build_foundation_model(hf_dir, weights_path=hf_dir, device=dev).module
        state = build_train_state(model, build_optimizer(
            model, lr=build_lr_scheduler(lr=1e-4, train_steps=HF_STEPS)))
        batch = {k: torch.from_numpy(v).to(dev) for k, v in rec_a.first_batch.items()}
        _, m = build_train_step(Transformer.loss_fn)(state, batch)
        bare = float(m["loss"])
        rel = abs(float(a[1]["loss"]) - bare) / abs(bare)
        log(f"hf trainer step-1 parity: trainer loss {float(a[1]['loss']):.6f}, "
            f"build_train_step {bare:.6f} (rel {rel:.2e}, tol {TOL_LOSS_REL})")
        if not rel <= TOL_LOSS_REL:
            raise AssertionError(f"hf trainer step-1 loss departs from build_train_step's ({rel})")
        del model, state, batch, m
        torch.cuda.empty_cache()

        # leg B: prefetch 0 (no export): the same losses bit for bit
        trainer, rec_b, b_launches, b_fallbacks, _, _, _ = leg(
            os.path.join(tmp, "b"), "--train.prefetch_depth=0", "--train.save_hf_weights=false")
        del trainer
        destroy_parallel_state()
        torch.cuda.empty_cache()
        check_counts(b_launches, b_fallbacks, {"flash_fwd": n, "flash_bwd_dkv": n,
                                               "flash_bwd_dq": n}, "hf trainer leg B")
        for i in range(1, HF_STEPS + 1):
            la, lb = float(a[i]["loss"]), float(rec_b.steps[i]["loss"])
            if la != lb:
                raise AssertionError(f"hf trainer: step {i} loss with prefetch 2 {la!r} != "
                                     f"with prefetch 0 {lb!r}")
        log(f"hf trainer: losses of steps 1-{HF_STEPS} with prefetch 2 and prefetch 0 are the "
            f"same bit for bit")
        return launches
    finally:
        torch.use_deterministic_algorithms(was_deterministic)
        gc.collect()  # a trainer's reference cycles would hold its ~18 GB of state
        torch.cuda.empty_cache()


def loss_grads(dev, preset: str, layers: int, pins, keep):
    """Gradients of the parameters whose names end with one of ``keep``
    after one ``loss_fn`` backward at full width, ``layers`` deep, S=1024,
    B=4, with the ops pinned as ``pins`` says."""
    from veomni_tpu_torch.models import Transformer
    from veomni_tpu_torch.ops.kernel_registry import apply_ops_config
    from veomni_tpu_torch.train_text_step import SEED, bench_config, packed_batches

    cfg = bench_config(preset, num_hidden_layers=layers)
    model = Transformer(cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev)
    batch = {k: torch.from_numpy(v[0]).to(dev)
             for k, v in next(packed_batches(cfg.vocab_size, 1024, 4)).items()}
    apply_ops_config(pins)
    try:
        loss, _ = model.loss_fn(batch)
        loss.backward()
    finally:
        apply_ops_config(None)
    return {name: p.grad for name, p in model.named_parameters() if name.endswith(keep)}


def step_parity(dev, preset: str, layers: int, pins, tag: str):
    """One train step with the kernels against the same step with ``pins``."""
    from veomni_tpu_torch.train_text_step import run_train_steps

    kern = run_train_steps(1024, 4, 1, preset=preset, num_layers=layers, device=dev)[0]
    torch.cuda.empty_cache()
    plain = run_train_steps(1024, 4, 1, preset=preset, num_layers=layers, device=dev,
                            ops_config=pins)[0]
    torch.cuda.empty_cache()
    d_loss = abs(kern["loss"] - plain["loss"]) / abs(plain["loss"])
    d_gn = abs(kern["grad_norm"] - plain["grad_norm"]) / abs(plain["grad_norm"])
    log(f"parity ({tag}): loss kernels {kern['loss']:.6f} plain {plain['loss']:.6f} "
        f"(rel {d_loss:.2e}, tol {TOL_LOSS_REL}); grad_norm kernels {kern['grad_norm']:.6f} "
        f"plain {plain['grad_norm']:.6f} (rel {d_gn:.2e}, tol {TOL_GRAD_NORM_REL}); "
        f"moe_aux_loss kernels {kern['moe_aux_loss']:.6f} plain {plain['moe_aux_loss']:.6f}")
    if not (d_loss <= TOL_LOSS_REL and d_gn <= TOL_GRAD_NORM_REL):
        raise AssertionError(f"kernel step disagrees with the plain step ({tag})")


def leaf_parity(g_kern, g_plain):
    worst = 0.0
    for name, ref in g_plain.items():
        rel = ((g_kern[name] - ref).norm() / ref.norm()).item()
        log(f"  grad {name}: |kernels - plain| / |plain| = {rel:.2e} (tol {TOL_LEAF_REL})")
        worst = max(worst, rel) if math.isfinite(rel) else math.inf
    if worst > TOL_LEAF_REL:
        raise AssertionError(f"gradients disagree ({worst} > {TOL_LEAF_REL})")


def phase_parity(dev):
    """Dense: 2 layers, kernels vs plain attention."""
    step_parity(dev, "qwen3_0p6b", 2, {"attention": "xla"}, "dense, 2 layers, S=1024, B=4")
    launched, _ = read_counts()
    proj = ("q_proj", "k_proj", "v_proj", "o_proj")
    g_kern = loss_grads(dev, "qwen3_0p6b", 2, {"attention": "cuda_flash"}, proj)
    now, _ = read_counts()
    if sum(now.values()) - sum(launched.values()) != 2 * 3:  # 2 layers x (K1, K2, K3)
        raise AssertionError(f"kernel leg of the gradient parity launched {now}")
    g_plain = loss_grads(dev, "qwen3_0p6b", 2, {"attention": "xla"}, proj)
    leaf_parity(g_kern, g_plain)
    torch.cuda.empty_cache()


def phase_moe_parity(dev):
    """MoE: 1 layer (the router's input does not depend on any grouped
    GEMM, so both legs route alike), grouped-GEMM kernels vs the plain
    ragged impl."""
    step_parity(dev, MOE_PRESET, 1, {"group_gemm": "xla"}, "MoE, 1 layer, S=1024, B=4")
    launched, _ = read_counts()
    moe = ("router", "gate_proj", "up_proj", "down_proj")
    g_kern = loss_grads(dev, MOE_PRESET, 1, {"group_gemm": "cuda_gmm"}, moe)
    now, _ = read_counts()
    if any(now[k] - launched[k] != want for k, want in
           (("gmm_fwd", 6), ("gmm_dlhs", 3), ("gmm_t", 3))):
        raise AssertionError(f"kernel leg of the MoE gradient parity launched {now}")
    torch.cuda.empty_cache()
    g_plain = loss_grads(dev, MOE_PRESET, 1, {"group_gemm": "xla"}, moe)
    leaf_parity(g_kern, g_plain)
    torch.cuda.empty_cache()


# --------------------------------------------------------------------------
# The dense HF dialects: Gemma-3-1B, Llama-3.2-1B, Qwen2.5-1.5B from HF
# directories through TextTrainer
# --------------------------------------------------------------------------
DIALECT_YAML = """
model:
  config_path: {hf}
  model_path: {hf}
data:
  train_path: {data}
  data_type: pretokenized
  max_seq_len: {seq}
train:
  micro_batch_size: {micro_bs}
  train_steps: {steps}
  bf16: true
  param_dtype: float32
  enable_gradient_checkpointing: true
  gradient_checkpointing_policy: ctx
  lr: 1.0e-4
  lr_decay_style: cosine
  seed: 0
  save_hf_weights: {save_hf}
  log_steps: 1
"""
DIALECT_SEQ = 4096
DIALECT_MICRO_BS = 4
GEMMA_PRESET = "gemma3_1b"
GEMMA_STEPS = 3  # was 6, then 4: cut to make room for the VLM, then the serving phases
DIALECT_STEPS = 2  # cut with the remat and int8 serving phases (was 3)
DIALECT_PRESETS = ("llama3p2_1b", "qwen2p5_1p5b")
# half the published depth (26, 16, 28 layers), cut when slice E's checks
# joined the script, to keep the whole run under 1100 s: the layouts, the
# window pattern (2 of Gemma's 13 layers full attention) and every check stay
DIALECT_LAYERS = {"gemma3_1b": 13, "llama3p2_1b": 8, "qwen2p5_1p5b": 14}
DIALECT_NAMES = {"gemma3_1b": "Gemma-3-1B", "llama3p2_1b": "Llama-3.2-1B",
                 "qwen2p5_1p5b": "Qwen2.5-1.5B"}


# The parallel phase: two ranks on the one card over gloo (NCCL keeps one rank
# a device; gloo takes these collectives on CUDA tensors,
# tools/collective_probe.py), each leg through TextTrainer in a launcher's
# world that the trainer joins itself, its first two steps against the same
# trainer at world size 1. Both world sizes read the same documents at each
# step: a corpus of one global batch of PARALLEL_DOC-token documents, four
# filling each row exactly, so each step is an epoch of the same documents
# however the rows are split over ranks or micro-batches. The floor of the
# comparison (``--phases parallel_floor``) is the world-1 trainer against
# itself with each step's rows split into two gradient-accumulation
# micro-batches (the same update, other GEMM shapes and summation order; the
# MoE without its balance term, which a micro-batch computes over its own
# tokens), against itself on the corpus in reverse order (each step the same
# documents, other rows) and with both, each on three corpora. A step-2 gap
# is one draw of a heavy-tailed spread (Adam's first update, and in the MoE
# the routing it flips), so the floor is the largest of the nine draws.
# PARALLEL_TOL is 4x it, rounded up (PERF.md §6). The balance loss has only
# the reverse order's draws and is held at step 1, where both world sizes
# compute it on the same weights: at step 2 it reads weights that the step-1
# update's rounding already moved (Adam's first update turns a near-zero
# gradient's rounding into +-lr), which the loss and grad norm hold.
PARALLEL_STEPS = 2
PARALLEL_SEQ = 4096
PARALLEL_DOC = 1024
PARALLEL_MOE_LAYERS = 2
PARALLEL_LEGS = {
    # Qwen3-0.6B at full depth, 4 rows, ulysses 2 (dp 1: both ranks read the
    # same rows; each keeps half of every row's sequence and, after the
    # all-to-all, 8 of 16 q heads and 4 of 8 kv heads): step 1 and a
    # checkpoint there, then a fresh trainer restores it and runs step 2
    "dense": dict(rows=4, rank_rows=4, resume=True,
                  flags=("--train.ulysses_parallel_size=2",)),
    # Qwen3-30B-A3B widths, 2 rows, ep 2 = dp 2 (one row a rank, 64 of 128
    # experts a rank, dropless buckets); cut to PARALLEL_MOE_LAYERS (the MoE
    # phase runs 4): at 4 two ranks ran the card out of memory
    "moe": dict(rows=2, rank_rows=1, resume=False,
                flags=("--train.expert_parallel_size=2",)),
}
# floors (largest of nine draws): dense loss 9.09e-6, grad norm 2.87e-4; MoE
# loss 4.01e-5, grad norm 9.95e-4, balance loss 5.56e-5
PARALLEL_TOL = {"dense": {"loss": 3.7e-5, "grad_norm": 1.2e-3},
                "moe": {"moe_aux_loss": 2.3e-4, "loss": 1.7e-4, "grad_norm": 4e-3}}
PARALLEL_AUX_STEP = 1  # the step whose balance loss is held
PARALLEL_FLOOR_SEEDS = (0, 1, 2)  # the floor's corpora (the legs read seed 0's)
PARALLEL_YAML = """
model:
  config_overrides: {model}
data:
  train_path: {data}
  data_type: pretokenized
  max_seq_len: {seq}
  samples_per_micro_batch: {docs}
train:
  micro_batch_size: {rows}
  train_steps: {steps}
  bf16: true
  param_dtype: float32
  enable_gradient_checkpointing: true
  gradient_checkpointing_policy: ctx
  lr: 1.0e-4
  lr_decay_style: cosine
  enable_full_determinism: true
  seed: 0
  save_hf_weights: false
  prefetch_depth: 0
  log_steps: 1
"""


def parallel_models() -> dict:
    """{leg: the model's config_overrides}: the trainer phase's Qwen3-0.6B
    (tools/trainer_profile.py) and, on its fields, Qwen3-30B-A3B's published
    widths at PARALLEL_MOE_LAYERS layers."""
    import yaml

    from veomni_tpu_torch.tools.trainer_profile import TRAINER_YAML
    from veomni_tpu_torch.train_text_step import BENCH_PRESETS

    dense = yaml.safe_load(TRAINER_YAML.format(data="corpus.jsonl", steps=1, seed=0))["model"][
        "config_overrides"]
    return {"dense": dense, "moe": {**dense, **BENCH_PRESETS[MOE_PRESET],
                                    "num_hidden_layers": PARALLEL_MOE_LAYERS}}


def write_parallel_run(tmp: str, leg: str, model: dict, rows: int, *, seq: int = PARALLEL_SEQ,
                       doc: int = PARALLEL_DOC, steps: int = PARALLEL_STEPS,
                       reverse: bool = False, seed: int = 0) -> str:
    """A leg's corpus (one global batch: ``rows`` x seq/doc documents of
    exactly ``doc`` tokens, uniform over the vocabulary, from ``seed``; in
    reverse order with ``reverse``) and YAML under ``tmp``; returns the
    YAML's path."""
    import yaml

    rng = np.random.default_rng(seed)
    docs = [rng.integers(0, model["vocab_size"], doc).tolist()
            for _ in range(rows * (seq // doc))]
    name = f"{leg}{'_reversed' if reverse else ''}"
    data = os.path.join(tmp, f"{name}.jsonl")
    with open(data, "w") as f:
        for ids in docs[::-1] if reverse else docs:
            f.write(json.dumps({"input_ids": ids}) + "\n")
    path = os.path.join(tmp, f"{name}.yaml")
    with open(path, "w") as f:
        f.write(PARALLEL_YAML.format(model=yaml.safe_dump(model, default_flow_style=True,
                                                         width=1 << 20).strip(),
                                     data=data, seq=seq,
                                     docs=seq // doc, rows=rows, steps=steps))
    return path


def parallel_train(cfg_path: str, flags, *, stop_at=None, checkpoints: bool = True,
                   final_save: bool = True, digest: bool = False, first_step=None):
    """TextTrainer from ``cfg_path`` and ``flags`` (the launcher's world,
    where there is one, joined by the trainer itself), trained: (trainer,
    {step: loss, grad_norm, moe_aux_loss, step_ok}, its first step, the
    state digest after on_train_begin (a restore included) or None).
    ``stop_at`` stops it after that step; without ``checkpoints`` it saves
    and restores nothing, without ``final_save`` it skips the save at train
    end; ``first_step(trainer)`` is called before step 1."""
    from veomni_tpu_torch.arguments import VeOmniArguments, parse_args
    from veomni_tpu_torch.trainer import TextTrainer
    from veomni_tpu_torch.trainer.callbacks import Callback, CheckpointCallback

    records, begin = {}, {}

    class Record(Callback):
        def on_train_begin(self, trainer, state):
            begin["step"] = state.global_step
            begin["digest"] = state_digest(trainer.train_state) if digest else None

        def on_step_begin(self, trainer, state):
            if first_step is not None and state.global_step == 0:
                first_step(trainer)

        def on_step_end(self, trainer, state):
            m = state.metrics
            records[state.global_step] = {k: float(m[k]) for k in (
                "loss", "grad_norm", "moe_aux_loss", "step_ok") if k in m}
            if state.global_step == stop_at:
                state.should_stop = True

    trainer = TextTrainer(parse_args(VeOmniArguments, [cfg_path, *flags]))
    for cb in trainer.callbacks:
        if isinstance(cb, CheckpointCallback) and not final_save:
            cb.on_train_end = lambda trainer, state: None  # its state is not read
    if not checkpoints:
        trainer.callbacks = [cb for cb in trainer.callbacks
                             if not isinstance(cb, CheckpointCallback)]
    trainer.callbacks.append(Record())
    trainer.train()
    trainer.checkpointer.close()
    return trainer, records, begin["step"], begin["digest"]


def parallel_ranks(rank: int, world: int, payload: dict) -> dict:
    """A rank of the parallel phase: each leg of ``payload["legs"]`` in turn
    through ``parallel_train``, its memory freed between. A resumed leg
    trains step 1 and saves it, then a fresh trainer restores the
    checkpoint (its state digest held against the saved one) and trains
    step 2; the census counts the first trainer's step only. Returns, a
    leg: the records, the kernels' launches and plain dispatches, the
    collective census of step 1 beside the plan's reckoning, the backend
    and device the trainer chose, the send/recv calls staged through the
    host, the mesh coordinates and peak device memory."""
    from veomni_tpu_torch.observability.comm import get_comm_census, plan_step_bytes
    from veomni_tpu_torch.observability.metrics import get_registry
    from veomni_tpu_torch.parallel import functional
    from veomni_tpu_torch.parallel.parallel_state import destroy_parallel_state

    reg = get_registry()
    out = {}
    for leg, run in payload["legs"].items():
        t0 = time.perf_counter()
        reset_all_counts()
        staged0 = functional.HOST_STAGED_CALLS
        spans0 = {n: reg.histogram_sum(f"span.ckpt.{n}") for n in ("save", "wait", "restore")}
        flags = [*run["flags"], f"--train.output_dir={run['out']}"]
        os.environ["VEOMNI_COST_CENSUS"] = "1"
        trainer, records, _, _ = parallel_train(
            run["yaml"], flags + ["--train.save_steps=1"] if run["resume"] else flags,
            stop_at=1 if run["resume"] else None, checkpoints=run["resume"])
        if run["resume"]:
            saved = state_digest(trainer.train_state)  # step 1's state, as saved
        ps = trainer.parallel_state
        a, b, s = trainer.current_batch["input_ids"].shape
        s //= ps.sp_size
        rec = get_comm_census().get("train_step", f"{a}x{b}x{s}")
        res = {"census": dict(rec.bytes_by_kind) if rec is not None else {},
               "plan": plan_step_bytes(trainer.layout, a, b, s),
               "backend": torch.distributed.get_backend(), "device": str(trainer.device),
               "sp_rank": ps.sp_rank(), "dp_rank": trainer.dataloader.dp_rank,
               "dp_size": trainer.dataloader.dp_size}
        del trainer
        destroy_parallel_state()
        gc.collect()
        torch.cuda.empty_cache()
        if run["resume"]:
            # the restart: the census is off (its step would count again)
            os.environ["VEOMNI_COST_CENSUS"] = "0"
            trainer, more, first, restored = parallel_train(
                run["yaml"], flags + ["--train.save_steps=0"], final_save=False, digest=True)
            records.update(more)
            step_dir = os.path.join(run["out"], "checkpoints", "global_step_1")
            res["resume"] = {
                "first_step": first, "digest_equal": restored == saved,
                "digest_entries": len(saved),
                "ckpt_bytes": sum(os.path.getsize(os.path.join(d, f))
                                  for d, _, files in os.walk(step_dir) for f in files),
                **{f"{n}_s": reg.histogram_sum(f"span.ckpt.{n}") - v for n, v in spans0.items()}}
            del trainer
            destroy_parallel_state()
            gc.collect()
            torch.cuda.empty_cache()
            os.environ["VEOMNI_COST_CENSUS"] = "1"
        launches, fallbacks = read_counts()
        res.update(records={str(k): v for k, v in records.items()}, launches=launches,
                   fallbacks=fallbacks, host_staged=functional.HOST_STAGED_CALLS - staged0,
                   peak_bytes=int(torch.cuda.max_memory_allocated())
                   if torch.cuda.is_available() else 0, wall_s=time.perf_counter() - t0)
        if torch.cuda.is_available():
            torch.cuda.reset_peak_memory_stats()
        out[leg] = res
    return out


def parallel_launch_want(leg: str) -> dict:
    """Launches of K1-K6 in one rank's PARALLEL_STEPS steps of a leg (``ctx``:
    the attention is not rerun; the MoE layer's K4s are, in the recompute of
    the post-attention block)."""
    if leg == "dense":
        n = LAYERS * PARALLEL_STEPS
        return {"flash_fwd": n, "flash_bwd_dkv": n, "flash_bwd_dq": n}
    n = PARALLEL_MOE_LAYERS * PARALLEL_STEPS
    return {"flash_fwd": n, "flash_bwd_dkv": n, "flash_bwd_dq": n, "gmm_fwd": 6 * n,
            "gmm_dlhs": 3 * n, "gmm_t": 3 * n}


def parallel_world1(dev, yaml_path: str, out: str, rows: int, micro_rows=None, first_step=None):
    """A leg's PARALLEL_STEPS steps through TextTrainer at world size 1,
    ``rows`` a step in micro-batches of ``micro_rows`` (all of them by
    default): {step: record}."""
    from veomni_tpu_torch.parallel.parallel_state import destroy_parallel_state

    flags = [f"--train.output_dir={out}", f"--train.micro_batch_size={micro_rows or rows}",
             f"--train.global_batch_size={rows}"]
    was_deterministic = torch.are_deterministic_algorithms_enabled()
    try:
        trainer, records, _, _ = parallel_train(yaml_path, flags, checkpoints=False,
                                                first_step=first_step)
    finally:
        torch.use_deterministic_algorithms(was_deterministic)
    del trainer
    destroy_parallel_state()
    gc.collect()
    torch.cuda.empty_cache()
    return records


def parallel_rel(got: dict, ref: dict, key: str) -> float:
    return abs(got[key] / ref[key] - 1)


def phase_parallel_floor(dev, card):
    """The floors of the parallel phase's comparison (not in a whole run):
    each leg's world-1 trainer against itself (a) with each step's rows in
    two gradient-accumulation micro-batches, (b) on the corpus in reverse
    order and (c) both, on the corpora of PARALLEL_FLOOR_SEEDS; for each,
    the largest relative gap over PARALLEL_STEPS steps of the loss, the grad
    norm and the balance loss, then the largest over all. A micro-batch
    computes the balance loss over its own tokens, another function, so (a)
    and (c) run the MoE without the balance term (router_aux_loss_coef 0)
    and read no balance loss."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_parallel_floor_")
    try:
        for leg, model in parallel_models().items():
            rows, keys = PARALLEL_LEGS[leg]["rows"], list(PARALLEL_TOL[leg])
            split_model = dict(model, router_aux_loss_coef=0.0) if "num_experts" in model \
                else model
            split_keys = [k for k in keys if k != "moe_aux_loss"]
            worst = {}
            for seed in PARALLEL_FLOOR_SEEDS:
                def run(name, mdl, micro_rows=None, reverse=False):
                    d = os.path.join(tmp, f"{leg}-{seed}-{name}")
                    os.makedirs(d)
                    path = write_parallel_run(d, leg, mdl, rows, reverse=reverse, seed=seed)
                    return parallel_world1(dev, path, os.path.join(d, "out"), rows, micro_rows)

                base = run("base", model)
                split_base = run("no_aux", split_model) if split_model is not model else base
                pairs = {"two micro-batches": (split_base, run("two", split_model, rows // 2),
                                               split_keys),
                         "reverse order": (base, run("reverse", model, reverse=True), keys),
                         "both": (split_base, run("both", split_model, rows // 2,
                                                  reverse=True), split_keys)}
                for name, (ref, got, ks) in pairs.items():
                    gaps = {k: [parallel_rel(got[i], ref[i], k)
                                for i in range(1, PARALLEL_STEPS + 1)] for k in ks}
                    log(f"parallel floor {leg}, corpus seed {seed}, {name}: rel gaps at steps "
                        f"1-{PARALLEL_STEPS} "
                        f"{ {k: [f'{x:.3e}' for x in v] for k, v in gaps.items()} }")
                    for k, v in gaps.items():
                        worst[k] = max(worst.get(k, 0.0), *v)
            log(f"parallel floor {leg}: largest rel gap over every draw "
                f"{ {k: f'{v:.3e}' for k, v in worst.items()} }, 4x "
                f"{ {k: f'{4 * v:.3e}' for k, v in worst.items()} } [{card}]")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_parallel(dev, card):
    """Two ranks on the card through the trainer (see PARALLEL_LEGS): loss
    and grad norm at each step against world size 1 within PARALLEL_TOL,
    both ranks agreeing, the dense leg's restart restoring the saved state
    bit for bit, gloo chosen by the trainer for ranks that share the card,
    K1-K6 launching in each rank as reckoned, no plain attention dispatch,
    the collective census of a step equal by kind to the bytes the plan
    reckons; then K1-K3 at a rank's Ulysses head layout on the dense batch
    and K4-K6 at a rank's capacity-padded local expert groups, each against
    its plain version. Returns ({path: launches summed over the ranks}, the
    K1-K3 rows at the Ulysses layout)."""
    from veomni_tpu_torch.parallel.launch import run_ranks

    tmp = tempfile.mkdtemp(prefix="chip_smoke_parallel_")
    try:
        return parallel_legs(dev, card, tmp, run_ranks)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def parallel_legs(dev, card, tmp, run_ranks):
    models = parallel_models()
    legs, ref, first = {}, {}, {}

    def dense_batch(trainer):
        first["seg"] = torch.from_numpy(trainer.current_batch["segment_ids"][0]).to(dev)

    def moe_groups(trainer):  # rank 0's local groups at ep 2 on the init weights
        model = trainer.train_state.model
        batch = {k: torch.from_numpy(v[0]).to(dev) for k, v in trainer.current_batch.items()}
        counts = layer0_expert_counts(model, batch).cpu()
        ep, k = 2, model.cfg.num_experts_per_tok
        sizes = counts[:model.cfg.num_experts // ep].clone()
        # each source rank sends every destination cap = t_loc x k slots
        # (dropless); the empty ones go to the last local expert, zeroed
        sizes[-1] += ep * PARALLEL_LEGS["moe"]["rank_rows"] * PARALLEL_SEQ * k - sizes.sum()
        first["sizes"] = sizes

    for leg, opts in PARALLEL_LEGS.items():
        yaml_path = write_parallel_run(tmp, leg, models[leg], opts["rows"])
        ref[leg] = parallel_world1(dev, yaml_path, os.path.join(tmp, f"{leg}1"), opts["rows"],
                                   first_step=dense_batch if leg == "dense" else moe_groups)
        legs[leg] = {"yaml": yaml_path, "out": os.path.join(tmp, f"{leg}2"),
                     "resume": opts["resume"],
                     "flags": [*opts["flags"], f"--train.micro_batch_size={opts['rank_rows']}"]}
    t0 = time.perf_counter()
    ranks = run_ranks(2, "chip_smoke:parallel_ranks", {"legs": legs}, device="cuda",
                      timeout=600, join=False,
                      env={"PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True"})
    log(f"parallel: two ranks on the card in {time.perf_counter() - t0:.1f} s "
        f"(startup and both legs) [{card}]")
    by_path = {}
    for leg in PARALLEL_LEGS:
        r0 = ranks[0][leg]
        kinds = sorted(r0["census"])
        staged = sum(r[leg]["host_staged"] for r in ranks)
        log(f"parallel {leg}: {r0['wall_s']:.1f} s on rank 0 with the trainers' builds; "
            f"transport: {r0['backend']} on {r0['device']} tensors ({', '.join(kinds)}), "
            f"{staged} send/recv calls staged through the host")
        if any(r[leg]["backend"] != "gloo" for r in ranks):
            raise AssertionError(f"parallel {leg}: two ranks on one card joined over "
                                 f"{[r[leg]['backend'] for r in ranks]}, not gloo")
        tol = PARALLEL_TOL[leg]
        for i in range(1, PARALLEL_STEPS + 1):
            got = [r[leg]["records"][str(i)] for r in ranks]
            want = ref[leg][i]
            if got[0] != got[1]:
                raise AssertionError(f"parallel {leg} step {i}: the ranks disagree: {got}")
            if not all(math.isfinite(g["loss"]) and g["step_ok"] for g in got):
                raise AssertionError(f"parallel {leg} step {i}: not finite: {got}")
            rel = {k: parallel_rel(got[0], want, k) for k in tol}
            if i != PARALLEL_AUX_STEP:
                rel.pop("moe_aux_loss", None)
            log(f"parallel {leg} step {i}: "
                + ", ".join(f"{k}={got[0][k]:.9f} (world 1 {want[k]:.9f}, "
                            + (f"rel {rel[k]:.3e}, limit {tol[k]:.1e})" if k in rel else
                               f"rel {parallel_rel(got[0], want, k):.3e}, not held)")
                            for k in tol))
            if rel.get("moe_aux_loss", 0.0) > tol.get("moe_aux_loss", 1.0):
                raise AssertionError(f"parallel {leg} step {i}: moe_aux_loss world 2 against "
                                     f"world 1 rel {rel['moe_aux_loss']:.3e} over "
                                     f"{tol['moe_aux_loss']}")
            bad = {k: v for k, v in rel.items() if v > tol[k]}
            if bad:
                raise AssertionError(f"parallel {leg} step {i}: world 2 against world 1 "
                                     f"{bad} over {tol}")
        want = parallel_launch_want(leg)
        total = {}
        for rank, r in enumerate(ranks):
            r = r[leg]
            check_counts(r["launches"], r["fallbacks"], want, f"parallel {leg} rank {rank}")
            for name, n in r["launches"].items():
                total[name] = total.get(name, 0) + n
            log(f"parallel {leg} rank {rank}: sp_rank {r['sp_rank']}, dp_rank {r['dp_rank']} "
                f"of {r['dp_size']}, launches {r['launches']}, FALLBACK_CALLS "
                f"{r['fallbacks']}, peak {r['peak_bytes'] / 2**30:.2f} GiB; collective census "
                f"of step 1 (bytes by kind) {r['census']}, the plan's reckoning {r['plan']}")
            if r["census"] != r["plan"]:
                raise AssertionError(f"parallel {leg} rank {rank}: census {r['census']} != "
                                     f"the plan's {r['plan']}")
            if "resume" in r:
                z = r["resume"]
                log(f"parallel {leg} rank {rank}: checkpoint of step 1 ({z['ckpt_bytes'] / 1e9:.3f}"
                    f" GB on rank {rank}'s view of the disk; save {z['save_s'] + z['wait_s']:.2f}"
                    f" s, restore {z['restore_s']:.2f} s); the restart began at step "
                    f"{z['first_step']} with {'the saved' if z['digest_equal'] else 'ANOTHER'} "
                    f"state ({z['digest_entries'] - 1} tensors and the update count)")
                if z["first_step"] != 1 or not z["digest_equal"]:
                    raise AssertionError(f"parallel {leg} rank {rank}: the restart did not "
                                         f"restore step 1's state: {z}")
        if {r[leg]["dp_rank"] for r in ranks} != ({0} if leg == "dense" else {0, 1}):
            raise AssertionError(f"parallel {leg}: dp ranks {[r[leg]['dp_rank'] for r in ranks]}")
        by_path[f"parallel_{leg}"] = total
    # the kernels at the shapes a rank gives them: K1-K3 on the dense leg's
    # first batch (each rank attends over every row's whole sequence)
    ulysses = phase_flash(dev, first["seg"], 8, 4, "Qwen3-0.6B, a rank's heads under ulysses 2")
    torch.cuda.empty_cache()
    sizes = first["sizes"]
    log(f"parallel moe: rank 0's local expert groups, layer 0, first batch (routed at world 1 "
        f"on the same weights and rows): {int(sizes.sum())} rows over {sizes.numel()} experts, "
        f"the last one holding {int(sizes[-1])} (its own plus the zeroed empty slots), "
        f"{int((sizes == 0).sum())} empty")
    gmm_case(dev, sizes, 2048, 768, "EP rank 0 local experts, gate/up: K=2048 N=768",
             timed=True)
    gmm_case(dev, sizes, 768, 2048, "EP rank 0 local experts, down: K=768 N=2048")
    torch.cuda.empty_cache()
    return by_path, ulysses


def random_model(dev, cfg, seed: int = 0):
    """The port's random init from ``seed``, with router correction biases
    drawn from N(0, CORRECTION_BIAS_STD) (the init's 0 would let noaux-tc
    pick by score order alone); for gpt_oss, sinks from N(0, 1) and every
    bias from N(0, GPT_OSS_BIAS_STD) (the init's 0 would hide a dropped
    sink or bias); and zero-centered norm weights
    at 0, as HF initialises Gemma3's norms (a gain of 1). The reference's
    init puts every norm weight at 1 (``init_params``), a gain of 2 under a
    zero-centered norm at each of Gemma's four norms a layer: the random
    model is then chaotic in bf16 (at 26 layers its bf16 first-token logits
    sit up to 6.8 from the f32 re-score, the logits' own spread ~1.4), so no
    bf16-against-f32 gate could tell a fault from that."""
    from veomni_tpu_torch.models import Transformer

    model = Transformer(cfg, torch.Generator(device=dev).manual_seed(seed), device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if cfg.norm_zero_centered and name.endswith("norm"):
                p.zero_()
            elif name.endswith("e_score_correction_bias"):  # noaux-tc: off the score order
                p.copy_(torch.randn(p.shape, generator=gen, device=dev) * CORRECTION_BIAS_STD)
            elif cfg.model_type == "gpt_oss" and name.endswith(("sinks", "_bias")):
                std = 1.0 if name.endswith("sinks") else GPT_OSS_BIAS_STD
                p.copy_(torch.randn(p.shape, generator=gen, device=dev) * std)
    return model


def write_random_hf_dir(dev, hf_dir: str, preset: str, layers=None):
    """An HF directory of ``preset``'s published config.json (with
    ``num_hidden_layers`` set to ``layers`` where the depth is cut) holding
    random bf16 weights from seed 0 (``random_model``), written by the
    port's save_hf_checkpoint; returns the config."""
    from veomni_tpu_torch.models import TransformerConfig
    from veomni_tpu_torch.models.hf_io import save_hf_checkpoint
    from veomni_tpu_torch.train_text_step import HF_CONFIGS

    published = dict(HF_CONFIGS[preset])
    if layers is not None:
        published["num_hidden_layers"] = layers
        if "layer_types" in published:  # Gemma-3's per-layer window pattern
            published["layer_types"] = published["layer_types"][:layers]
    cfg = TransformerConfig.from_hf_config(published, param_dtype=torch.bfloat16)
    written = random_model(dev, cfg)
    save_hf_checkpoint(written, cfg, hf_dir)
    del written
    torch.cuda.empty_cache()
    with open(os.path.join(hf_dir, "config.json"), "w") as f:
        json.dump(published, f, indent=2)
    return cfg


def write_dialect_run(dev, tmp: str, preset: str, steps: int, save_hf: bool,
                      layers=None, micro_bs: int = DIALECT_MICRO_BS) -> str:
    """A run's inputs under ``tmp``: the HF directory (random bf16 weights
    from seed 0 by ``random_model``, written by the port's
    save_hf_checkpoint, then the published config.json, with
    ``num_hidden_layers`` set to ``layers`` where the depth is cut), a
    pretokenized corpus (documents of S/16-S/2 tokens, 256-2048 at S 4096,
    uniform over the model's vocabulary, seed 0) and the YAML; returns the
    YAML's path."""
    cfg = write_random_hf_dir(dev, os.path.join(tmp, "hf"), preset, layers)
    return write_corpus_and_yaml(tmp, preset, cfg.vocab_size, steps, save_hf, micro_bs)


def write_corpus_and_yaml(tmp: str, preset: str, vocab: int, steps: int, save_hf: bool,
                          micro_bs: int) -> str:
    """The corpus and YAML of ``write_dialect_run`` beside the HF directory
    ``tmp``/hf; returns the YAML's path."""
    hf_dir = os.path.join(tmp, "hf")
    rng = np.random.default_rng(0)
    data = os.path.join(tmp, "corpus.jsonl")
    # the loader offers 8 documents a row to the packing collator, a
    # micro-batch at a time: enough for every step's offer, in one epoch
    with open(data, "w") as f:
        for _ in range(8 * micro_bs * (steps + 2)):
            n = int(rng.integers(DIALECT_SEQ // 16, DIALECT_SEQ // 2 + 1))
            f.write(json.dumps({"input_ids": rng.integers(0, vocab, n).tolist()}) + "\n")
    path = os.path.join(tmp, f"{preset}.yaml")
    with open(path, "w") as f:
        f.write(DIALECT_YAML.format(hf=hf_dir, data=data, seq=DIALECT_SEQ,
                                    micro_bs=micro_bs, steps=steps,
                                    save_hf=str(save_hf).lower()))
    return path


def check_hf_export(dev, tag: str, out: str, final) -> None:
    """The trainer's HF export in ``out`` reads back bit-equal to the
    model ``final``'s parameters."""
    from veomni_tpu_torch.models import Transformer
    from veomni_tpu_torch.models.hf_io import hf_to_params

    back = hf_to_params(out, final.cfg, Transformer(final.cfg, None, device=dev))
    bad = [n for (n, x), (_, y) in zip(back.named_parameters(), final.named_parameters())
           if not torch.equal(x, y)]
    if bad:
        raise AssertionError(f"{tag}: the HF export differs from the final parameters "
                             f"in {len(bad)} tensors, e.g. {bad[:3]}")
    nbytes = sum(os.path.getsize(os.path.join(out, f)) for f in os.listdir(out))
    log(f"{tag}: the HF export ({nbytes / 1e9:.3f} GB) reads back bit-equal to the final "
        f"parameters")


def phase_hf_dialect(dev, card, preset: str, steps: int, *, export: bool):
    """One dense HF dialect at full width and ``DIALECT_LAYERS`` deep through ``TextTrainer``
    from an HF directory: ``steps`` steps at seq 4096, f32 master, bf16
    compute, ctx remat, AdamW. K1-K3 launch once a step for each
    full-attention layer, all at the model's head dim; each windowed layer
    is one of the reference's feature dispatches to the plain attention
    (``FALLBACK_CALLS``). The step-1 loss is held to the same step with
    the plain attention pinned; with ``export`` the HF export at the end
    reads back bit-equal to the final parameters. Returns (launches, the
    first packed batch's segment ids [B, S] on the card)."""
    from veomni_tpu_torch.arguments import VeOmniArguments, parse_args
    from veomni_tpu_torch.models import Transformer
    from veomni_tpu_torch.models.auto import build_foundation_model
    from veomni_tpu_torch.ops.cuda import flash_attention as fa
    from veomni_tpu_torch.optim import build_lr_scheduler, build_optimizer
    from veomni_tpu_torch.parallel.parallel_state import destroy_parallel_state
    from veomni_tpu_torch.train import build_train_state, build_train_step
    from veomni_tpu_torch.trainer import TextTrainer
    from veomni_tpu_torch.train_text_step import HF_CONFIGS
    from veomni_tpu_torch.trainer.callbacks import Callback, CheckpointCallback
    from veomni_tpu_torch.utils.count_flops import FlopsCounter
    from veomni_tpu_torch.utils.device import get_device_peak_flops

    name = DIALECT_NAMES[preset]
    tag = f"hf dialect {name}"
    depth = f"{DIALECT_LAYERS[preset]} of {HF_CONFIGS[preset]['num_hidden_layers']} layers"

    class Record(Callback):
        def __init__(self):
            self.steps, self.first_batch = {}, None

        def on_step_begin(self, trainer, state):
            if self.first_batch is None:
                self.first_batch = {k: v.copy() for k, v in trainer.current_batch.items()}

        def on_step_end(self, trainer, state):
            m = state.metrics
            self.steps[state.global_step] = dict(loss=float(m["loss"]),
                                                 grad_norm=float(m["grad_norm"]),
                                                 t=time.perf_counter())

    tmp = tempfile.mkdtemp(prefix=f"chip_smoke_{preset}_")
    try:
        t0 = time.perf_counter()
        yaml_path = write_dialect_run(dev, tmp, preset, steps, export,
                                      layers=DIALECT_LAYERS[preset])
        write_s = time.perf_counter() - t0
        args = parse_args(VeOmniArguments, [yaml_path, f"--train.output_dir={tmp}/out"])
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_all_counts()
        trainer = TextTrainer(args)
        cfg = trainer.train_state.model.cfg
        # the trainer phase holds checkpoints; this one saves none (a full
        # f32 state of 16-25 GB would cost the run ~30 s)
        trainer.callbacks = [cb for cb in trainer.callbacks
                             if not isinstance(cb, CheckpointCallback)]
        rec = Record()
        trainer.callbacks.append(rec)
        trainer.train()
        trainer.checkpointer.close()
        launches, fallbacks = read_counts()
        by_dim = {d: dict(c) for d, c in fa.LAUNCHES_BY_HEAD_DIM.items()}
        peak = torch.cuda.max_memory_allocated(dev)
        windows = [cfg.window_for_layer(i) for i in range(cfg.num_hidden_layers)]
        n_full = windows.count(0)
        n_params = sum(p.numel() for p in trainer.train_state.model.parameters())
        log(f"{tag}: {depth} ({n_full} full attention, "
            f"{len(windows) - n_full} with window {max(windows)}), hidden {cfg.hidden_size}, "
            f"heads {cfg.num_attention_heads}/{cfg.num_key_value_heads}, head dim "
            f"{cfg.head_dim}, vocab {cfg.vocab_size}, {n_params} parameters; HF directory "
            f"and corpus written in {write_s:.1f} s; TextTrainer at seq {DIALECT_SEQ}, "
            f"micro-batch {DIALECT_MICRO_BS}, f32 master, bf16 compute, ctx remat, AdamW "
            f"[{card}]")
        a = rec.steps
        check_steps([dict(loss=r["loss"], grad_norm=r["grad_norm"], step_ok=True)
                     for r in a.values()], tag)
        tokens = DIALECT_MICRO_BS * DIALECT_SEQ
        flops = FlopsCounter.from_config(cfg).batch_flops(tokens, DIALECT_SEQ)
        peak_flops = get_device_peak_flops(dev)
        ms = [(a[i]["t"] - a[i - 1]["t"]) * 1e3 for i in range(2, steps + 1)]
        for i in range(1, steps + 1):
            extra = (f" step_ms={ms[i - 2]:.1f} tokens_per_s={tokens / ms[i - 2] * 1e3:.1f} "
                     f"mfu={flops / (ms[i - 2] / 1e3) / peak_flops:.4f}" if i >= 2
                     else " (first step: warm-up, not timed)")
            log(f"{tag} step {i}: loss={a[i]['loss']:.6f} grad_norm={a[i]['grad_norm']:.6f}"
                f"{extra} [{card}]")
        want = {"flash_fwd": n_full * steps, "flash_bwd_dkv": n_full * steps,
                "flash_bwd_dq": n_full * steps}
        bad = {k: v for k, v in launches.items() if v != want.get(k, 0)}
        if bad or fallbacks["flash"] != (len(windows) - n_full) * steps:
            raise AssertionError(f"{tag}: launches {launches} (expected {want}), "
                                 f"FALLBACK_CALLS {fallbacks} (expected "
                                 f"{(len(windows) - n_full) * steps}: the windowed layers)")
        if any(by_dim[d][k] != (want[k] if d == cfg.head_dim else 0)
               for d in by_dim for k in by_dim[d]):
            raise AssertionError(f"{tag}: launches by head dim {by_dim}, expected all at "
                                 f"D={cfg.head_dim}")
        med = sorted(ms)[len(ms) // 2]
        log(f"{tag}: warm steps 2-{steps} {', '.join(f'{x:.1f}' for x in ms)} ms, median "
            f"{med:.1f} ms, {tokens / med * 1e3:.1f} tokens/s (packed rows, padding included), "
            f"MFU {flops / (med / 1e3) / peak_flops:.4f} (full causal attention counted on "
            f"every layer, as the reference's FlopsCounter does); peak device memory "
            f"{peak / 2**30:.2f} GiB; launches {launches} (all at D={cfg.head_dim}: "
            f"{n_full} full-attention layers x {steps} steps), FALLBACK_CALLS {fallbacks} "
            f"({len(windows) - n_full} windowed layers x {steps} steps, the reference's "
            f"dispatch to the plain attention) [{card}]")
        if export:
            check_hf_export(dev, tag, os.path.join(tmp, "out", "hf_ckpt"),
                            trainer.train_state.model)
        first = rec.first_batch
        del trainer
        destroy_parallel_state()
        gc.collect()
        torch.cuda.empty_cache()

        # step-1 parity: the same weights and batch with the plain attention
        # pinned (every layer through _attention_xla: its blockwise form at
        # S 4096)
        hf_dir = os.path.join(tmp, "hf")
        fm = build_foundation_model(hf_dir, weights_path=hf_dir, device=dev,
                                    ops_implementation={"attention": "xla"},
                                    remat_policy="ctx")
        model = fm.module
        state = build_train_state(model, build_optimizer(
            model, lr=build_lr_scheduler(lr=1e-4, train_steps=steps)))
        batch = {k: torch.from_numpy(v).to(dev) for k, v in first.items()}
        reset_all_counts()
        try:
            _, m = build_train_step(Transformer.loss_fn)(state, batch)
        finally:
            from veomni_tpu_torch.ops.kernel_registry import apply_ops_config

            apply_ops_config(None)
        plain = float(m["loss"])
        plain_launches, _ = read_counts()
        rel = abs(a[1]["loss"] - plain) / abs(plain)
        log(f"{tag} step-1 parity: trainer (kernels) loss {a[1]['loss']:.6f}, plain attention "
            f"{plain:.6f} (rel {rel:.2e}, tol {TOL_LOSS_REL}; {depth}; the plain leg "
            f"launched {plain_launches})")
        if not rel <= TOL_LOSS_REL or any(plain_launches.values()):
            raise AssertionError(f"{tag}: step-1 loss departs from the plain attention's "
                                 f"({rel}) or the plain leg launched kernels")
        del fm, model, state, batch, m
        gc.collect()
        torch.cuda.empty_cache()
        seg = torch.from_numpy(first["segment_ids"][0]).to(dev)
        return launches, seg
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# per preset: (q heads, kv heads, head dim) of its kernel rows
DIALECT_HEADS = {"gemma3_1b": (4, 1, 256), "llama3p2_1b": (32, 8, 64),
                 "qwen2p5_1p5b": (12, 2, 128)}


def dialect_rows(dev, preset: str, seg):
    """K1-K3 held and timed at the preset's head layout on its trainer
    phase's own first packed batch; Gemma-3-1B's rows also carry its first
    row alone (micro-batch 1). Each row counts the launches of its preset's
    paths only (``path_layout``)."""
    hq, hkv, d = DIALECT_HEADS[preset]
    name = DIALECT_NAMES[preset]
    rows = phase_flash(dev, seg, hq, hkv, f"{name} layout", d=d)
    torch.cuda.empty_cache()
    if preset == GEMMA_PRESET:
        mb1 = phase_flash(dev, seg[:1].contiguous(), hq, hkv, f"{name}, micro-batch 1", d=d)
        for row, one in zip(rows, mb1):
            row["micro_batch_1"] = {k: one[k] for k in LAYOUT_KEYS}
        torch.cuda.empty_cache()
    for row in rows:
        row["path_layout"] = preset
    return rows


def phase_hf_trainer_gemma3(dev, card):
    """Gemma-3-1B at full width and 13 of 26 layers, 3 steps, HF export; then
    K1-K3 on its first packed batch. Returns ({path: (launches, head dim,
    preset)}, kernel rows)."""
    launches, seg = phase_hf_dialect(dev, card, GEMMA_PRESET, GEMMA_STEPS, export=True)
    paths = {"hf_trainer_gemma3": (launches, DIALECT_HEADS[GEMMA_PRESET][2], GEMMA_PRESET)}
    return paths, dialect_rows(dev, GEMMA_PRESET, seg)


def phase_dialects(dev, card):
    """Llama-3.2-1B and Qwen2.5-1.5B at full width and half depth, 2 steps each,
    each followed by K1-K3 on its first packed batch."""
    paths, rows = {}, []
    for preset in DIALECT_PRESETS:
        launches, seg = phase_hf_dialect(dev, card, preset, DIALECT_STEPS, export=False)
        paths[f"dialects_{preset}"] = (launches, DIALECT_HEADS[preset][2], preset)
        rows += dialect_rows(dev, preset, seg)
    return paths, rows


# --------------------------------------------------------------------------
# The deepseek MoE dialect: Moonlight-16B-A3B and DeepSeek-V2-Lite from HF
# directories through TextTrainer
# --------------------------------------------------------------------------
MOONLIGHT_PRESET = "moonlight_16b_a3b"
# of 27: the leading dense layer and 1 MoE layer (4 until the remat and int8
# serving phases joined the script: cut to keep the whole run near 1000 s)
MOONLIGHT_LAYERS = 2
MOONLIGHT_STEPS = 3  # cut with the remat and int8 serving phases (was 4)
V2_LITE_PRESET = "deepseek_v2_lite"
V2_LITE_LAYERS = 2  # the leading dense layer and 1 MoE layer
V2_LITE_STEPS = 3
DEEPSEEK_MICRO_BS = 2  # x seq 4096: M = 8192 x top-6 = 49152 routed rows per MoE layer
DEEPSEEK_NAMES = {MOONLIGHT_PRESET: "Moonlight-16B-A3B", V2_LITE_PRESET: "DeepSeek-V2-Lite"}
# the kernel rows of K4-K6 at the deepseek expert widths (K/N 2048/1408 and
# 1408/2048) count the launches of both deepseek paths
DEEPSEEK_LAYOUT = "deepseek 2048x1408"
# the random HF directory's router correction biases: N(0, 0.05), against a
# spread of ~0.01 between neighbouring sigmoid scores of 64 experts at the
# init's router width, so noaux-tc picks other experts than the score order
CORRECTION_BIAS_STD = 0.05
# chip_smoke's own f32 version of one MLA + MoE layer against the port's
# bf16 layer, token by token (a token's head vectors flattened):
#   rms(got - ref) <= LAYER_RTOL * rms(ref token) + LAYER_ATOL * rms(ref),
# The port runs the layer in bf16 (q/k/v, probabilities, expert outputs, the
# weighted sum each rounded to 2^-9 relative), so a token lands ~1e-2 off;
# 5% of the token's size, 2% of the tensor's for tokens near zero. A rope
# that turns the wrong channels, a missing shared expert or an expert
# choice without the correction bias moves most tokens by 20% or more.
LAYER_RTOL = 5e-2
LAYER_ATOL = 2e-2
# DeepSeek-V3's router (its published config.json): 256 experts in 8 groups,
# top-4 groups, top-8, sigmoid noaux-tc, routed scaling 2.5, hidden 7168
V3_ROUTER = dict(hidden_size=7168, num_experts=256, num_experts_per_tok=8, n_group=8,
                 topk_group=4, scoring_func="sigmoid", norm_topk_prob=True,
                 routed_scaling_factor=2.5)
V3_ROUTER_TOKENS = 4096


def deepseek_param_count(cfg) -> int:
    """The model's parameter count from its config, counted here: MLA
    attention and two norms per layer, a dense gated MLP on the leading
    ``first_k_dense_replace`` layers, router, correction bias, routed and
    shared experts on the others, embedding, final norm and head."""
    h, nh = cfg.hidden_size, cfg.num_attention_heads
    dn, dr, dv, r = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim, cfg.kv_lora_rank
    q = (h * cfg.q_lora_rank + cfg.q_lora_rank + cfg.q_lora_rank * nh * (dn + dr)
         if cfg.q_lora_rank else h * nh * (dn + dr))
    attn = q + h * (r + dr) + r + r * nh * (dn + dv) + nh * dv * h + 2 * h
    dense = 3 * h * cfg.intermediate_size
    e, im = cfg.num_experts, cfg.moe_intermediate_size
    moe = h * e + (e if cfg.scoring_func == "sigmoid" else 0) + 3 * e * h * im
    moe += 3 * h * im * cfg.n_shared_experts
    k = cfg.first_k_dense_replace
    body = k * (attn + dense) + (cfg.num_hidden_layers - k) * (attn + moe)
    return body + cfg.vocab_size * h * (1 if cfg.tie_word_embeddings else 2) + h


def reference_route(logits, bias, cfg):
    """chip_smoke's own routing (f32 logits [T,E] in): scores (sigmoid, or
    softmax), the expert choice (scores + correction bias for sigmoid)
    limited to each token's best ``topk_group`` groups (a group scored by
    its two best choices, or its best softmax score), the top k of the
    choice (the lower index first among equals), the weights from the
    scores (renormed, scaled)."""
    t, e = logits.shape
    scores = logits.sigmoid() if cfg.scoring_func == "sigmoid" else logits.softmax(-1)
    choice = scores + bias if cfg.scoring_func == "sigmoid" else scores.clone()
    if cfg.n_group and cfg.topk_group and cfg.n_group > 1:
        g = choice.view(t, cfg.n_group, e // cfg.n_group)
        if cfg.scoring_func == "sigmoid":
            group_score = g.sort(dim=-1, descending=True, stable=True).values[..., :2].sum(-1)
        else:
            group_score = g.max(-1).values
        best = group_score.argsort(dim=-1, descending=True, stable=True)[:, :cfg.topk_group]
        keep = torch.zeros(t, cfg.n_group, dtype=torch.bool, device=logits.device)
        keep[torch.arange(t, device=logits.device)[:, None], best] = True
        keep = keep[:, :, None].expand(t, cfg.n_group, e // cfg.n_group).reshape(t, e)
        choice = choice.masked_fill(~keep, -math.inf if cfg.scoring_func == "sigmoid" else 0.0)
    idx = choice.argsort(dim=-1, descending=True, stable=True)[:, :cfg.num_experts_per_tok]
    w = scores.gather(1, idx)
    if cfg.norm_topk_prob:
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
    return idx, w * cfg.routed_scaling_factor


def phase_v3_router(dev, card):
    """``route_tokens`` at DeepSeek-V3's router width on the card, against
    the same call on the CPU (the port's plain path) and chip_smoke's own
    routing: 4096 tokens, hidden 7168, 256 experts in 8 groups (top-4
    groups), top-8, sigmoid with a nonzero correction bias. The inputs sit
    on coarse grids (x in 2^-3 steps, router in 2^-5, the bias in 2^-6), so
    each f32 logit is exact in any summation order and many tie: the three
    must pick the same experts, the lower index first among equals, and
    their weights agree to rtol 1e-6."""
    from veomni_tpu_torch.models import TransformerConfig
    from veomni_tpu_torch.models.transformer import route_tokens

    cfg = TransformerConfig(model_type="deepseek_v3", **V3_ROUTER)
    gen = torch.Generator().manual_seed(3)
    x = (torch.randint(-2, 3, (V3_ROUTER_TOKENS, 7168), generator=gen) / 8).bfloat16()
    router = (torch.randint(-2, 3, (7168, 256), generator=gen) / 32).bfloat16()
    bias = (torch.randint(-4, 5, (256,), generator=gen) / 64).bfloat16()
    idx_c, w_c, _ = route_tokens(x, router, cfg, bias)
    idx_g, w_g, _ = route_tokens(x.to(dev), router.to(dev), cfg, bias.to(dev))
    torch.cuda.synchronize()
    idx_r, w_r = reference_route(x.double() @ router.double(), bias.double(), cfg)
    same_card = torch.equal(idx_g.cpu(), idx_c)
    same_ref = torch.equal(idx_c, idx_r)
    w_err = max(((w_g.cpu() - w_c).abs() / w_c.abs()).max().item(),
                ((w_c.double() - w_r).abs() / w_r.abs()).max().item())
    score_order = (x.float() @ router.float()).argsort(dim=-1, descending=True, stable=True)[:, :8]
    moved = (idx_c.sort(-1).values != score_order.sort(-1).values).any(-1).float().mean().item()
    log(f"router check (DeepSeek-V3 width): {V3_ROUTER_TOKENS} tokens, hidden 7168, 256 experts "
        f"in 8 groups (top-4), top-8, sigmoid + correction bias: indices card == CPU "
        f"{same_card}, CPU == chip_smoke's routing {same_ref}; weights worst rel err "
        f"{w_err:.2e} (tol 1e-6); the bias and the groups move {moved:.1%} of the tokens' "
        f"expert sets off the plain score order [{card}]"
        + ("" if same_card and same_ref and w_err <= 1e-6 else " FAILED"))
    if not (same_card and same_ref and w_err <= 1e-6):
        raise AssertionError("router check (DeepSeek-V3 width): routing disagrees")


def token_check(tag, got, ref):
    """Hold ``got`` to ``ref`` [T, ...] token by token (LAYER_RTOL,
    LAYER_ATOL); log the worst ratio and raise if any token is over."""
    got, ref = got.float().flatten(1), ref.float().flatten(1)
    err = (got - ref).pow(2).mean(1).sqrt()
    allowed = LAYER_RTOL * ref.pow(2).mean(1).sqrt() + LAYER_ATOL * ref.pow(2).mean().sqrt()
    ratio = err / allowed
    over = int((ratio > 1).sum())
    log(f"{tag}: worst token error/allowed {ratio.max().item():.3f}, {over} of {ratio.numel()} "
        f"tokens over" + (" FAILED" if over else ""))
    if over:
        raise AssertionError(f"{tag}: the port's layer disagrees with chip_smoke's")


def phase_deepseek_layer(dev, card, model, batch):
    """The first MoE layer (layer 1) of the model as loaded, on the first
    row of ``batch`` [B, S], held to chip_smoke's own f32 version of it:
    the MLA block's q and k (q, the kv latent and its norm, the rope as a
    complex turn of each adjacent channel pair by position x
    theta^(-2i/d)) and its output (causal and same-document attention,
    o_proj) from the same input, and the MoE
    block (router, correction bias, top-k, the 64 experts one at a time,
    the shared experts) from the port's MoE input. Returns the group sizes
    of the layer's routing over the whole batch (the kernel rows' M)."""
    from veomni_tpu_torch.models.transformer import expert_counts, route_tokens

    cfg, dt = model.cfg, model.cfg.dtype
    layer = model.layers[1]
    p = {n: w.detach().to(dt).float() for n, w in layer.named_parameters()}
    nh, dn, dr, dv = (cfg.num_attention_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                      cfg.v_head_dim)
    r, h = cfg.kv_lora_rank, cfg.hidden_size
    ids, pos, seg = (batch[k].to(dev) for k in ("input_ids", "position_ids", "segment_ids"))
    with torch.no_grad():
        hidden, cos, sin = model.embed_and_rotary(ids, pos)
        q, k, v = layer._qkv(hidden, cos, sin)
        attn = layer._attend(q, k, v, seg)
        h1, x = layer.mlp_input(hidden, attn)
        got_attn = (h1 - hidden)[0]
        flat = x.reshape(-1, h)
        got_moe, _ = layer.moe(flat[:ids.shape[1]])
        idx_all, _, _ = route_tokens(flat, layer.router.to(dt), cfg,
                                     layer.e_score_correction_bias.to(dt))
        sizes = expert_counts(idx_all.reshape(-1), cfg.num_experts)

        def rms(t, w):
            return t * torch.rsqrt(t.pow(2).mean(-1, keepdim=True) + cfg.rms_norm_eps) * w

        def turn(t, position):  # [S, n, dr]: adjacent pairs as complex numbers
            inv = cfg.rope_theta ** (-torch.arange(0, dr, 2, device=dev).double() / dr)
            ang = position.double()[:, None] * inv
            z = torch.view_as_complex(t.double().reshape(*t.shape[:-1], dr // 2, 2).contiguous())
            return torch.view_as_real(z * torch.polar(torch.ones_like(ang), ang)[:, None]) \
                .flatten(-2).float()

        s = ids.shape[1]
        hf = hidden[0].float()
        xa = rms(hf, p["input_layernorm"])
        qf = (xa @ p["q_proj"]).view(s, nh, dn + dr)
        kv_a = xa @ p["kv_a_proj_with_mqa"]
        kv = (rms(kv_a[:, :r], p["kv_a_layernorm"]) @ p["kv_b_proj"]).view(s, nh, dn + dv)
        qf = torch.cat([qf[..., :dn], turn(qf[..., dn:], pos[0])], -1)
        kf = torch.cat([kv[..., :dn], turn(kv_a[:, None, r:], pos[0]).expand(s, nh, dr)], -1)
        logits = torch.einsum("qhd,khd->hqk", qf, kf) * (dn + dr) ** -0.5
        visible = (torch.arange(s, device=dev)[:, None] >= torch.arange(s, device=dev)[None]) \
            & (seg[0][:, None] == seg[0][None])
        probs = logits.masked_fill(~visible, -math.inf).softmax(-1)
        ref_attn = torch.einsum("hqk,khd->qhd", probs, kv[..., dn:]).reshape(s, nh * dv) \
            @ p["o_proj"]
        del logits, probs
        xm = flat[:s].float()
        ridx, rw = reference_route(xm @ p["router"], p["e_score_correction_bias"], cfg)
        ref_moe = torch.zeros_like(xm)
        for e in range(cfg.num_experts):
            tok, slot = (ridx == e).nonzero(as_tuple=True)
            if tok.numel():
                xe = xm[tok]
                ye = (torch.nn.functional.silu(xe @ p["experts.gate_proj"][e])
                      * (xe @ p["experts.up_proj"][e])) @ p["experts.down_proj"][e]
                ref_moe.index_add_(0, tok, ye * rw[tok, slot, None])
        ref_moe += (torch.nn.functional.silu(xm @ p["shared_experts.gate_proj"])
                    * (xm @ p["shared_experts.up_proj"])) @ p["shared_experts.down_proj"]
    name = DEEPSEEK_NAMES[MOONLIGHT_PRESET]
    log(f"{name} layer check: layer 1 (MLA + MoE) on the first row ({s} tokens) against "
        f"chip_smoke's f32 layer [{card}]")
    token_check(f"{name} layer check: MLA q/k", torch.cat([q[0], k[0]], 1),
                torch.cat([qf, kf], 1))
    token_check(f"{name} layer check: MLA block", got_attn, ref_attn)
    token_check(f"{name} layer check: MoE block", got_moe, ref_moe)
    return sizes


def describe_deepseek(cfg) -> str:
    n_moe = cfg.num_hidden_layers - cfg.first_k_dense_replace
    return (f"{cfg.num_hidden_layers} of 27 layers ({cfg.first_k_dense_replace} dense, "
            f"{n_moe} MoE), hidden {cfg.hidden_size}, {cfg.num_attention_heads} heads, MLA "
            f"kv_lora_rank {cfg.kv_lora_rank}, q/k head {cfg.qk_head_dim}, v head "
            f"{cfg.v_head_dim}, {cfg.num_experts} experts top-{cfg.num_experts_per_tok} of width "
            f"{cfg.moe_intermediate_size} + {cfg.n_shared_experts} shared, {cfg.scoring_func} "
            f"routing, vocab {cfg.vocab_size}")


def phase_hf_deepseek(dev, card, preset: str, layers: int, steps: int, *, export: bool,
                      layer_check=None):
    """One deepseek-dialect model at its published widths through
    ``phase_hf_moe``: random bf16 weights from seed 0 with correction
    biases drawn nonzero, written by the port's save_hf_checkpoint; MLA's v
    head dim 128 against q/k's 192 takes the reference's dispatch to the
    plain attention on every layer."""

    def write(tmp):
        return write_dialect_run(dev, tmp, preset, steps, export, layers=layers,
                                 micro_bs=DEEPSEEK_MICRO_BS), None

    return phase_hf_moe(dev, card, preset, steps, export=export, dialect="deepseek",
                        name=DEEPSEEK_NAMES[preset], write=write, describe=describe_deepseek,
                        count=deepseek_param_count, layer_check=layer_check,
                        plain_why="every MLA layer")


def phase_hf_moe(dev, card, preset: str, steps: int, *, export: bool, dialect: str, name: str,
                 write, describe, count, layer_check=None, plain_why: str,
                 export_check=None):
    """One MoE-dialect model at its published widths (depth cut) through
    ``TextTrainer`` from an HF directory that ``write(tmp)`` writes (it
    returns the YAML's path and the written model, or None): ``steps``
    steps at seq 4096 x micro-batch 2, f32 master, bf16 compute, ctx remat,
    AdamW. Before the trainer, the loaded parameters against the written
    ones bit for bit (where ``write`` keeps them), the parameter count
    against ``count(cfg)`` and ``layer_check(dev, card, model, batch)``
    on a packed batch, if given. K4 launches 6 times per MoE layer and step
    (gate, up, down, and their ctx recompute), K5 and K6 3 times; K1-K3
    never (``plain_why`` takes the reference's dispatch to the plain
    attention, one FALLBACK_CALLS per layer and step). The step-1 loss,
    grad norm and router aux loss are held to the same step with the plain
    ragged grouped GEMM pinned; with ``export`` the HF export reads back
    bit-equal to the final parameters (and passes ``export_check``).
    Returns (launches, the layer check's group sizes or None)."""
    from veomni_tpu_torch.arguments import VeOmniArguments, parse_args
    from veomni_tpu_torch.models import Transformer
    from veomni_tpu_torch.models.auto import build_foundation_model
    from veomni_tpu_torch.ops.kernel_registry import apply_ops_config
    from veomni_tpu_torch.optim import build_lr_scheduler, build_optimizer
    from veomni_tpu_torch.parallel.parallel_state import destroy_parallel_state
    from veomni_tpu_torch.train import build_train_state, build_train_step
    from veomni_tpu_torch.train_text_step import packed_batches
    from veomni_tpu_torch.trainer import TextTrainer
    from veomni_tpu_torch.trainer.callbacks import Callback, CheckpointCallback
    from veomni_tpu_torch.utils.count_flops import FlopsCounter
    from veomni_tpu_torch.utils.device import get_device_peak_flops

    tag = f"hf {dialect} {name}"

    class Record(Callback):
        def __init__(self):
            self.steps, self.first_batch = {}, None

        def on_step_begin(self, trainer, state):
            if self.first_batch is None:
                self.first_batch = {k: v.copy() for k, v in trainer.current_batch.items()}

        def on_step_end(self, trainer, state):
            m = state.metrics
            self.steps[state.global_step] = dict(
                loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                moe_aux_loss=float(m["moe_aux_loss"]), t=time.perf_counter())

    tmp = tempfile.mkdtemp(prefix=f"chip_smoke_{preset}_")
    try:
        t0 = time.perf_counter()
        yaml_path, written = write(tmp)
        write_s = time.perf_counter() - t0
        hf_dir = os.path.join(tmp, "hf")
        t0 = time.perf_counter()
        fm = build_foundation_model(hf_dir, weights_path=hf_dir, device=dev)
        cfg, model = fm.config, fm.module
        load_s = time.perf_counter() - t0
        n_params = sum(w.numel() for w in model.parameters())
        want_params = count(cfg)
        n_moe = cfg.num_hidden_layers - cfg.first_k_dense_replace
        log(f"{tag}: {describe(cfg)}; {n_params} parameters (counted from the config: "
            f"{want_params}); HF directory and corpus written in {write_s:.1f} s, loaded in "
            f"{load_s:.1f} s [{card}]")
        if written is not None:
            bad = [n for (n, x), (_, y) in zip(model.named_parameters(), written.named_parameters())
                   if not torch.equal(x, y.to(x.dtype))]
            log(f"{tag}: the loaded parameters against the written ones: "
                + ("bit-equal" if not bad else f"{len(bad)} differ, e.g. {bad[:3]} FAILED"))
            if bad:
                raise AssertionError(f"{tag}: loaded parameters differ from the written ones "
                                     f"({bad[:3]})")
            del written
            torch.cuda.empty_cache()
        if n_params != want_params:
            raise AssertionError(f"{tag}: {n_params} parameters, the config gives {want_params}")
        sizes = None
        if layer_check is not None:
            batch = {k: torch.from_numpy(v[0]) for k, v in
                     next(packed_batches(cfg.vocab_size, DIALECT_SEQ, DEEPSEEK_MICRO_BS)).items()}
            sizes = layer_check(dev, card, model, batch)
        del fm, model
        gc.collect()
        torch.cuda.empty_cache()

        args = parse_args(VeOmniArguments, [yaml_path, f"--train.output_dir={tmp}/out"])
        torch.cuda.reset_peak_memory_stats(dev)
        reset_all_counts()
        trainer = TextTrainer(args)
        trainer.callbacks = [cb for cb in trainer.callbacks
                             if not isinstance(cb, CheckpointCallback)]
        rec = Record()
        trainer.callbacks.append(rec)
        trainer.train()
        trainer.checkpointer.close()
        launches, fallbacks = read_counts()
        peak = torch.cuda.max_memory_allocated(dev)
        a = rec.steps
        check_steps([dict(loss=r["loss"], grad_norm=r["grad_norm"], step_ok=True)
                     for r in a.values()], tag)
        tokens = DEEPSEEK_MICRO_BS * DIALECT_SEQ
        flops = FlopsCounter.from_config(cfg).batch_flops(tokens, DIALECT_SEQ)
        peak_flops = get_device_peak_flops(dev)
        ms = [(a[i]["t"] - a[i - 1]["t"]) * 1e3 for i in range(2, steps + 1)]
        for i in range(1, steps + 1):
            extra = (f" step_ms={ms[i - 2]:.1f} tokens_per_s={tokens / ms[i - 2] * 1e3:.1f} "
                     f"mfu={flops / (ms[i - 2] / 1e3) / peak_flops:.4f}" if i >= 2
                     else " (first step: warm-up, not timed)")
            log(f"{tag} step {i}: loss={a[i]['loss']:.6f} grad_norm={a[i]['grad_norm']:.6f} "
                f"moe_aux_loss={a[i]['moe_aux_loss']:.6f}{extra} [{card}]")
        want = {"gmm_fwd": 6 * n_moe * steps, "gmm_dlhs": 3 * n_moe * steps,
                "gmm_t": 3 * n_moe * steps}
        med = sorted(ms)[len(ms) // 2]
        log(f"{tag}: launches {launches} (reckoned from the code: {want}: per MoE layer and "
            f"step K4 x 6 (gate, up, down and their ctx recompute), K5 x 3, K6 x 3), "
            f"FALLBACK_CALLS {fallbacks} (expected {cfg.num_hidden_layers * steps}: {plain_why} "
            f"once a step); warm steps 2-{steps} {', '.join(f'{x:.1f}' for x in ms)} ms, "
            f"median {med:.1f} ms, {tokens / med * 1e3:.1f} tokens/s, MFU "
            f"{flops / (med / 1e3) / peak_flops:.4f} (the reference's FlopsCounter, every "
            f"layer counted as MoE, full causal attention on every layer); peak device memory "
            f"{peak / 2**30:.2f} GiB [{card}]")
        bad = {k: v for k, v in launches.items() if v != want.get(k, 0)}
        if bad or fallbacks["flash"] != cfg.num_hidden_layers * steps:
            raise AssertionError(f"{tag}: launches {launches} (expected {want}), "
                                 f"FALLBACK_CALLS {fallbacks}")
        if export:
            out_dir = os.path.join(tmp, "out", "hf_ckpt")
            check_hf_export(dev, tag, out_dir, trainer.train_state.model)
            if export_check is not None:
                export_check(tag, out_dir, trainer.train_state.model)
        first = rec.first_batch
        del trainer
        destroy_parallel_state()
        gc.collect()
        torch.cuda.empty_cache()

        # step-1 parity: the same weights and batch with the plain ragged
        # grouped GEMM pinned
        fm = build_foundation_model(hf_dir, weights_path=hf_dir, device=dev,
                                    ops_implementation={"group_gemm": "xla"}, remat_policy="ctx")
        model = fm.module
        state = build_train_state(model, build_optimizer(
            model, lr=build_lr_scheduler(lr=1e-4, train_steps=steps)))
        batch = {k: torch.from_numpy(v).to(dev) for k, v in first.items()}
        reset_all_counts()
        try:
            _, m = build_train_step(Transformer.loss_fn)(state, batch)
        finally:
            apply_ops_config(None)
        plain = {k: float(m[k]) for k in ("loss", "grad_norm", "moe_aux_loss")}
        plain_launches, _ = read_counts()
        rel = {k: abs(a[1][k] - plain[k]) / abs(plain[k]) for k in plain}
        tol = {"loss": TOL_LOSS_REL, "grad_norm": TOL_GRAD_NORM_REL, "moe_aux_loss": TOL_LOSS_REL}
        log(f"{tag} step-1 parity: trainer (K4-K6) against the plain ragged grouped GEMM: "
            + "; ".join(f"{k} {a[1][k]:.6f} vs {plain[k]:.6f} (rel {rel[k]:.2e}, tol {tol[k]})"
                        for k in plain)
            + f"; the plain leg launched {plain_launches}")
        if any(rel[k] > tol[k] for k in rel) or any(plain_launches.values()):
            raise AssertionError(f"{tag}: step 1 departs from the plain grouped GEMM's ({rel}) "
                                 f"or the plain leg launched kernels")
        del fm, model, state, batch, m
        gc.collect()
        torch.cuda.empty_cache()
        return launches, sizes
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_hf_trainer_moonlight(dev, card):
    """Moonlight-16B-A3B at its published widths, 4 of 27 layers (the
    leading dense layer and 3 MoE layers), 4 steps from an HF directory with
    its HF export, after the router check at DeepSeek-V3's width; then K4-K6
    held and timed at its expert widths on layer 1's routing of a packed
    batch. Returns ({path: (launches, head dim, layout)}, kernel rows)."""
    phase_v3_router(dev, card)
    launches, sizes = phase_hf_deepseek(dev, card, MOONLIGHT_PRESET, MOONLIGHT_LAYERS,
                                        MOONLIGHT_STEPS, export=True,
                                        layer_check=phase_deepseek_layer)
    s = sizes.cpu()
    log(f"grouped GEMM kernels at Moonlight-16B-A3B's expert widths: layer 1's routing of a "
        f"packed seq-{DIALECT_SEQ} x {DEEPSEEK_MICRO_BS} batch: M={int(s.sum())} rows over "
        f"E={s.numel()} experts, rows/expert min {int(s.min())} median {int(s.median())} "
        f"max {int(s.max())}")
    rows = gmm_case(dev, sizes, 2048, 1408, "Moonlight gate/up: K=2048 N=1408", timed=True)
    rows += gmm_case(dev, sizes, 1408, 2048, "Moonlight down: K=1408 N=2048", timed=True)
    for row in rows:
        row["path_layout"] = DEEPSEEK_LAYOUT
    # MLA: q/k head dim 192, so no flash row counts these paths
    return {"hf_trainer_moonlight": (launches, 192, DEEPSEEK_LAYOUT)}, rows


def phase_deepseek_v2_lite(dev, card):
    """DeepSeek-V2-Lite at its published widths, 2 of 27 layers, 3 steps:
    softmax greedy routing without renorm, yarn rope with its mscale on the
    MLA softmax scale."""
    launches, _ = phase_hf_deepseek(dev, card, V2_LITE_PRESET, V2_LITE_LAYERS, V2_LITE_STEPS,
                                    export=False)
    return {"deepseek_v2_lite": (launches, 192, DEEPSEEK_LAYOUT)}, []


# --------------------------------------------------------------------------
# The gpt_oss dialect: gpt-oss-20b at its published widths
# --------------------------------------------------------------------------
GPT_OSS_PRESET = "gpt_oss_20b"
GPT_OSS_NAME = "gpt-oss-20b"
# of 24: sliding, full (3 until the remat and int8 serving phases joined the
# script; 3 layers hold ~58 GB of f32 weight, grad and moments)
GPT_OSS_LAYERS = 2
GPT_OSS_STEPS = 3  # cut with the remat and int8 serving phases (was 4)
# the kernel rows of K4-K6 at gpt-oss's expert widths (K = N = 2880) count
# the launches of both gpt-oss paths
GPT_OSS_LAYOUT = "gpt_oss 2880x2880"
# The random gpt-oss weights: random_model draws sinks from N(0, 1) and
# every bias from N(0, GPT_OSS_BIAS_STD), matrices at the reference's init
# (std 0.02). There a gate or up pre-activation has a spread of ~1.1, so
# the clamp at 7 never bites, and an expert bias moves the MoE block by
# ~2% of a token, under the layer check's 5%. So the trainer phase's HF
# directory (write_gpt_oss_hf_dir) redraws the experts' gate and up weights
# from N(0, 0.1), which puts ~10% of the gate and ~20% of the up
# pre-activations beyond 7, the expert biases from N(0, 1) and the router
# bias from N(0, 0.1) (a scratch probe at these widths on 8 experts: the
# clamp left out 11x the allowance, the expert biases left out 4.5x,
# softmax before the top-k without its renorm 4.2x, bf16 against f32
# 0.08x). The serving phase keeps random_model's draws but at matrices of
# std GPT_OSS_SERVE_STD: at the reference's 0.02 a q or k channel has a
# spread of ~1.1, the attention logits (times yarn's attention factor
# squared, 1.81) ~2.1, and the random model is chaotic in bf16: its 24
# layers' first-token logits sat 2.29 (median) to 3.65 from the f32
# re-score on the H100, more than the logits' own spread of ~1.07, where
# no re-score gate could see a fault. The reference's own bf16 forward is
# as far from its f32 one at that init, so this is no fault of the port.
GPT_OSS_BIAS_STD = 0.02
GPT_OSS_SERVE_STD = 0.01
GPT_OSS_CHECK_STD = {"experts.gate_proj": 0.1, "experts.up_proj": 0.1,
                     "experts.gate_bias": 1.0, "experts.up_bias": 1.0,
                     "experts.down_bias": 1.0, "router_bias": 0.1}


def describe_gpt_oss(cfg) -> str:
    windows = [cfg.window_for_layer(i) for i in range(cfg.num_hidden_layers)]
    return (f"{cfg.num_hidden_layers} of 24 layers (windows {windows}), hidden "
            f"{cfg.hidden_size}, {cfg.num_attention_heads}/{cfg.num_key_value_heads} heads at "
            f"head dim {cfg.head_dim} with sinks and q/k/v/o biases, {cfg.num_experts} experts "
            f"top-{cfg.num_experts_per_tok} of width {cfg.intermediate_size} with biases, router "
            f"bias, {cfg.hidden_act}, yarn rope (factor {cfg.rope_scaling['factor']}, theta "
            f"{cfg.rope_theta}, truncate {cfg.rope_scaling.get('truncate', True)}), vocab "
            f"{cfg.vocab_size}")


def gpt_oss_param_count(cfg) -> int:
    """The model's parameter count from its config, counted here: q/k/v/o
    with their biases, the sinks and two norms per layer; the router and
    its bias, the experts' gate/up/down and their biases; embedding, final
    norm and head."""
    h, e, im = cfg.hidden_size, cfg.num_experts, cfg.intermediate_size
    q, kv = cfg.num_attention_heads * cfg.head_dim, cfg.num_key_value_heads * cfg.head_dim
    attn = 2 * h * q + 2 * h * kv + q + 2 * kv + h + cfg.num_attention_heads + 2 * h
    moe = h * e + e + 3 * e * h * im + 2 * e * im + e * h
    return cfg.num_hidden_layers * (attn + moe) + cfg.vocab_size * h * 2 + h


def write_gpt_oss_hf_dir(dev, hf_dir: str, layers: int):
    """An HF directory of gpt-oss-20b's published config.json (``layers``
    deep) holding random bf16 weights from seed 0 (``random_model``, with
    the MoE weights of ``GPT_OSS_CHECK_STD`` redrawn), its
    tensors named and laid out here as transformers' GptOss stores them:
    [out, in] linears, ``self_attn.sinks``, ``mlp.router.weight`` [E, H]
    and its bias, the experts fused as ``mlp.experts.gate_up_proj`` [E, H,
    2I] with gate in the even columns and up in the odd ones (its bias
    [E, 2I] likewise), ``down_proj`` [E, I, H] and its bias [E, H]; one
    shard per layer and one for the embeddings, with an index. Returns
    (config, the written model)."""
    from veomni_tpu_torch.models import TransformerConfig
    from veomni_tpu_torch.models.hf_io import INDEX_NAME, write_file
    from veomni_tpu_torch.train_text_step import HF_CONFIGS

    published = dict(HF_CONFIGS[GPT_OSS_PRESET], num_hidden_layers=layers)
    cfg = TransformerConfig.from_hf_config(published, param_dtype=torch.bfloat16)
    model = random_model(dev, cfg)
    gen = torch.Generator(device=dev).manual_seed(2)
    with torch.no_grad():
        for name, p in model.named_parameters():
            std = GPT_OSS_CHECK_STD.get(name.split(".", 2)[-1])
            if std is not None:
                p.copy_(torch.randn(p.shape, generator=gen, device=dev) * std)
    os.makedirs(hf_dir)

    def src(name, fn):  # the tensor is made again when its bytes are written
        t = fn()
        return (name, t.dtype, tuple(t.shape), lambda: fn().cpu())

    def interleave(a, b):
        out = torch.empty(*a.shape[:-1], 2 * a.shape[-1], dtype=a.dtype, device=a.device)
        out[..., 0::2], out[..., 1::2] = a, b
        return out

    def layer_tensors(layer):  # {HF suffix: producer} of one layer
        ex = layer.experts
        out = {"input_layernorm.weight": lambda: layer.input_layernorm,
               "post_attention_layernorm.weight": lambda: layer.post_attention_layernorm,
               "self_attn.sinks": lambda: layer.sinks,
               "mlp.router.weight": lambda: layer.router.t(),
               "mlp.router.bias": lambda: layer.router_bias,
               "mlp.experts.gate_up_proj": lambda: interleave(ex.gate_proj, ex.up_proj),
               "mlp.experts.gate_up_proj_bias": lambda: interleave(ex.gate_bias, ex.up_bias),
               "mlp.experts.down_proj": lambda: ex.down_proj,
               "mlp.experts.down_proj_bias": lambda: ex.down_bias}
        for p in "qkvo":
            out[f"self_attn.{p}_proj.weight"] = lambda p=p: layer.get_parameter(f"{p}_proj").t()
            out[f"self_attn.{p}_proj.bias"] = lambda p=p: layer.get_parameter(f"{p}_bias")
        return out

    index = {"metadata": {}, "weight_map": {}}
    with torch.no_grad():
        shards = [[src("model.embed_tokens.weight", lambda: model.embed_tokens),
                   src("model.norm.weight", lambda: model.norm),
                   src("lm_head.weight", lambda: model.lm_head.t())]]
        shards += [[src(f"model.layers.{i}.{n}", fn)
                    for n, fn in sorted(layer_tensors(layer).items())]
                   for i, layer in enumerate(model.layers)]
        for j, shard in enumerate(shards):
            fname = f"model-{j + 1:05d}-of-{len(shards):05d}.safetensors"
            write_file(os.path.join(hf_dir, fname), shard, {"format": "pt"})
            index["weight_map"].update({name: fname for name, *_ in shard})
    with open(os.path.join(hf_dir, INDEX_NAME), "w") as f:
        json.dump(index, f)
    with open(os.path.join(hf_dir, "config.json"), "w") as f:
        json.dump(published, f, indent=2)
    return cfg, model


def check_fused_export(tag: str, out: str, final) -> None:
    """The trainer's HF export holds gpt_oss's fused layout: each layer's
    ``gate_up_proj`` and its bias read straight from the files (no port
    code between) carry the final gate in the even columns and up in the
    odd ones, and ``mlp.router.weight`` is the router transposed."""
    from veomni_tpu_torch.models.hf_io import LazyHFTensors

    files = LazyHFTensors(out)
    bad = []
    for i, layer in enumerate(final.layers):
        pre, ex = f"model.layers.{i}.mlp", layer.experts
        for name, pair in (("experts.gate_up_proj", (ex.gate_proj, ex.up_proj)),
                           ("experts.gate_up_proj_bias", (ex.gate_bias, ex.up_bias))):
            fused = files.read(f"{pre}.{name}")
            if not (torch.equal(fused[..., 0::2], pair[0].detach().cpu())
                    and torch.equal(fused[..., 1::2], pair[1].detach().cpu())):
                bad.append(f"{pre}.{name}")
        if not torch.equal(files.read(f"{pre}.router.weight"), layer.router.detach().cpu().t()):
            bad.append(f"{pre}.router.weight")
    log(f"{tag}: the export's fused experts, read from its files: gate in the even columns, up "
        f"in the odd ones, router transposed: " + ("ok" if not bad else f"FAILED ({bad[:3]})"))
    if bad:
        raise AssertionError(f"{tag}: the export's fused layout is wrong in {bad[:3]}")


def gpt_oss_rope(cfg, dev):
    """chip_smoke's own rope for gpt-oss: yarn inverse frequencies [D/2]
    (f64) from the published values with the correction range left
    unrounded (``truncate`` false, as transformers reads it), and the
    attention factor 0.1 ln(factor) + 1 on cos and sin."""
    d, theta, rs = cfg.head_dim, cfg.rope_theta, cfg.rope_scaling
    factor, orig = float(rs["factor"]), float(rs["original_max_position_embeddings"])

    def dim(rotations):
        return d * math.log(orig / (rotations * 2 * math.pi)) / (2 * math.log(theta))

    low, high = max(dim(rs["beta_fast"]), 0.0), min(dim(rs["beta_slow"]), d - 1.0)
    base = theta ** (torch.arange(0, d, 2, dtype=torch.float64, device=dev) / d)
    ramp = ((torch.arange(d // 2, dtype=torch.float64, device=dev) - low) / (high - low))
    keep = 1 - ramp.clamp(0, 1)
    return 1 / (factor * base) * (1 - keep) + 1 / base * keep, 0.1 * math.log(factor) + 1.0


def gpt_oss_layer_check(dev, card, model, batch):
    """Layers 0 (a 128-token window) and 1 (full attention) of the model as
    loaded, on the first row of ``batch`` [B, S], each held token by token
    to chip_smoke's own f32 version of it from the port's input to that
    layer: q and k after the rope (``gpt_oss_rope``, each half-pair turned
    by position x frequency, times the attention factor), the attention
    block (biased q/k/v, causal same-document attention inside the window,
    each head's sink logit in the softmax denominator, biased o_proj) and
    the MoE block (top-4 of the biased router logits, the lower index first
    among equals, a softmax over those 4; each expert's biased gate and up,
    gate clamped to 7 and up to [-7, 7], (up + 1) * gate * sigmoid(1.702
    gate), biased down). Returns the group sizes of layer 0's routing over
    the whole batch (the kernel rows' M)."""
    from veomni_tpu_torch.models.transformer import expert_counts, route_tokens

    cfg, dt = model.cfg, model.cfg.dtype
    nh, nkv, d = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    ids, pos, seg = (batch[k].to(dev) for k in ("input_ids", "position_ids", "segment_ids"))
    s = ids.shape[1]
    inv_freq, att_factor = gpt_oss_rope(cfg, dev)

    def rms(t, w):
        return t * torch.rsqrt(t.pow(2).mean(-1, keepdim=True) + cfg.rms_norm_eps) * w

    def turn(t, position):  # [S, n, d]: channel i paired with i + d/2
        ang = position.double()[:, None] * inv_freq
        cos = (ang.cos() * att_factor).float()[:, None]
        sin = (ang.sin() * att_factor).float()[:, None]
        a, b = t[..., :d // 2], t[..., d // 2:]
        return torch.cat([a * cos - b * sin, b * cos + a * sin], -1)

    name = GPT_OSS_NAME
    sizes = None
    with torch.no_grad():
        hidden, cos, sin = model.embed_and_rotary(ids, pos)
        for i in (0, 1):
            layer = model.layers[i]
            window = cfg.window_for_layer(i)
            p = {n: w.detach().to(dt).float() for n, w in layer.named_parameters()}
            q, k, v = layer._qkv(hidden, cos, sin)
            attn = layer._attend(q, k, v, seg)
            # the block's output before the residual add: after layer 0's
            # MoE the residual stream is ~10x the attention output, and the
            # bf16 sum would round away ~2^-9 of the stream from it
            got_attn = layer._linear(attn.reshape(*attn.shape[:2], -1), "o_proj", "o_bias")[0]
            _, x = layer.mlp_input(hidden, attn)
            flat = x.reshape(-1, cfg.hidden_size)
            got_moe, _ = layer.moe(flat[:s])
            if i == 0:
                idx_all, _, _ = route_tokens(flat, layer.router.to(dt), cfg,
                                             router_bias=layer.router_bias.to(dt))
                sizes = expert_counts(idx_all.reshape(-1), cfg.num_experts)
            xa = rms(hidden[0].float(), p["input_layernorm"])
            qf = turn((xa @ p["q_proj"] + p["q_bias"]).view(s, nh, d), pos[0])
            kf = turn((xa @ p["k_proj"] + p["k_bias"]).view(s, nkv, d), pos[0])
            vf = (xa @ p["v_proj"] + p["v_bias"]).view(s, nkv, d)
            qi = torch.arange(s, device=dev)[:, None]
            ki = torch.arange(s, device=dev)[None]
            visible = (qi >= ki) & (seg[0][:, None] == seg[0][None])
            if window:
                visible &= qi - ki < window
            ctx = torch.empty(s, nh, d, device=dev)
            g = nh // nkv
            for j in range(nkv):  # one kv head's group of q heads at a time
                heads = slice(j * g, (j + 1) * g)
                logits = torch.einsum("qhd,kd->hqk", qf[:, heads], kf[:, j]) * d ** -0.5
                logits = logits.masked_fill(~visible, -math.inf)
                sink = p["sinks"][heads][:, None, None].expand(g, s, 1)
                probs = torch.cat([logits, sink], -1).softmax(-1)[..., :s]
                ctx[:, heads] = torch.einsum("hqk,kd->qhd", probs, vf[:, j])
                del logits, probs
            ref_attn = ctx.reshape(s, nh * d) @ p["o_proj"] + p["o_bias"]
            xm = flat[:s].float()
            logits = xm @ p["router"] + p["router_bias"]
            ridx = logits.argsort(dim=-1, descending=True, stable=True)[:, :cfg.num_experts_per_tok]
            rw = logits.gather(1, ridx).softmax(-1)
            ref_moe = torch.zeros_like(xm)
            clamped = [0, 0, 0]
            for e in range(cfg.num_experts):
                tok, slot = (ridx == e).nonzero(as_tuple=True)
                if tok.numel():
                    xe = xm[tok]
                    gate = xe @ p["experts.gate_proj"][e] + p["experts.gate_bias"][e]
                    up = xe @ p["experts.up_proj"][e] + p["experts.up_bias"][e]
                    clamped[0] += int((gate > 7).sum())
                    clamped[1] += int((up.abs() > 7).sum())
                    clamped[2] += gate.numel()
                    gate, up = gate.clamp(max=7), up.clamp(-7, 7)
                    ye = ((up + 1) * gate * torch.sigmoid(1.702 * gate)) @ p["experts.down_proj"][e]
                    ye = ye + p["experts.down_bias"][e]
                    ref_moe.index_add_(0, tok, ye * rw[tok, slot, None])
            log(f"{name} layer check: layer {i} ({f'window {window}' if window else 'full'} "
                f"attention + MoE) on the first row ({s} tokens) against chip_smoke's f32 layer; "
                f"the clamp bites on {clamped[0] / clamped[2]:.1%} of the routed gate and "
                f"{clamped[1] / clamped[2]:.1%} of the up pre-activations [{card}]")
            token_check(f"{name} layer check: layer {i} q/k", torch.cat([q[0], k[0]], 1),
                        torch.cat([qf, kf], 1))
            token_check(f"{name} layer check: layer {i} attention block", got_attn, ref_attn)
            token_check(f"{name} layer check: layer {i} MoE block", got_moe, ref_moe)
            del ctx, visible, ref_attn, ref_moe, xa, qf, kf, vf
            hidden = layer(hidden, cos, sin, seg)[0]
            torch.cuda.empty_cache()
    return sizes


def phase_hf_trainer_gpt_oss(dev, card):
    """gpt-oss-20b at its published widths, 3 of 24 layers, through
    ``phase_hf_moe``: an HF directory in the fused interleaved layout
    written by ``write_gpt_oss_hf_dir``, loaded bit-equal, the layer check,
    4 steps (sinks on every layer take the reference's dispatch to the
    plain attention), its HF export read back bit-equal and its fused
    layout read from the files; then K4-K6 held and timed at its expert
    widths (K = N = 2880) on layer 0's routing of a packed batch. Returns
    ({path: (launches, head dim, layout)}, kernel rows)."""

    def write(tmp):
        cfg, written = write_gpt_oss_hf_dir(dev, os.path.join(tmp, "hf"), GPT_OSS_LAYERS)
        return write_corpus_and_yaml(tmp, GPT_OSS_PRESET, cfg.vocab_size, GPT_OSS_STEPS, True,
                                     DEEPSEEK_MICRO_BS), written

    launches, sizes = phase_hf_moe(
        dev, card, GPT_OSS_PRESET, GPT_OSS_STEPS, export=True, dialect="gpt_oss",
        name=GPT_OSS_NAME, write=write, describe=describe_gpt_oss, count=gpt_oss_param_count,
        layer_check=gpt_oss_layer_check, plain_why="every layer (sinks)",
        export_check=check_fused_export)
    s = sizes.cpu()
    log(f"grouped GEMM kernels at {GPT_OSS_NAME}'s expert widths: layer 0's routing of a packed "
        f"seq-{DIALECT_SEQ} x {DEEPSEEK_MICRO_BS} batch: M={int(s.sum())} rows over "
        f"E={s.numel()} experts, rows/expert min {int(s.min())} median {int(s.median())} "
        f"max {int(s.max())}")
    rows = gmm_case(dev, sizes, 2880, 2880, f"{GPT_OSS_NAME} gate/up and down: K=2880 N=2880",
                    timed=True)
    for row in rows:
        row["path_layout"] = GPT_OSS_LAYOUT
    return {"hf_trainer_gpt_oss": (launches, 64, GPT_OSS_LAYOUT)}, rows


# --------------------------------------------------------------------------
# The SFT path: conversation data through the port's tokenizer, LoRA and the
# optimizer's parameter groups, at configs/text/lora_sft.yaml's knobs
# --------------------------------------------------------------------------
SFT_YAML = os.path.join("configs", "text", "lora_sft.yaml")
TOKENIZER_FIXTURES = os.path.join("tests", "fixtures", "tokenizers")
SFT_DOCS = ("README.md", "SURVEY.md", "docs/serving.md", "docs/performance.md",
            "docs/testing.md", "docs/observability.md", "docs/resilience.md")
SFT_ROWS = 192
SFT_SEQ = 4096  # lora_sft.yaml's max_seq_len
SFT_MICRO_BS = 2  # and micro_batch_size
SFT_DENSE_STEPS = 3  # cut with the remat and int8 serving phases (was 4)
SFT_GROUPS_STEPS = 2
SFT_FREEZE = ["^embed_tokens$"]
SFT_SCALES = {r"layers\.(q|k|v|o)_proj$": 0.1}
# weight decay, so that a frozen tensor with a zero gradient would still move
# if its update were not scaled by 0
SFT_GROUPS_DECAY = 0.1
# Qwen3-30B-A3B under LoRA: the frozen f32 base is ~2.49 GB a layer and the
# rank-16 adapters with their gradient and AdamW moments ~0.28 GB; with the
# embedding and head (2.49 GB), one layer's merged experts and their
# gradients in flight and the head's logits, 16 layers are reckoned at a
# ~59 GB peak (PERF.md §4)
SFT_MOE_LAYERS = 8  # cut with the remat and int8 serving phases (was 16)
SFT_MOE_STEPS = 4
SFT_MOE_CAPACITY = 2.0  # configs/text/qwen3_moe_ep.yaml's knob, read only under EP


def sft_conversations(path: str, rows: int, seed: int = 0) -> None:
    """Chat rows built from the paragraphs of the repo's docs: every other
    row opens with a system turn, then two or three user/assistant pairs,
    each turn one paragraph; no paragraph is used twice in a row, so each
    turn's text tells whose it is."""
    paras = []
    for name in SFT_DOCS:
        with open(name, encoding="utf-8") as f:
            paras += [p.strip() for p in f.read().split("\n\n") if len(p.strip()) > 80]
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for r in range(rows):
            picks = rng.choice(len(paras), size=7, replace=False)
            msgs = ([{"role": "system", "content": paras[picks[6]]}] if r % 2 else [])
            for i in range(2 * int(rng.integers(2, 4))):
                msgs.append({"role": ("user", "assistant")[i % 2], "content": paras[picks[i]]})
            f.write(json.dumps({"messages": msgs}) + "\n")


def check_label_mask(tokenizer, transform, rows, tag: str) -> int:
    """Every row through ``transform``: the decoded supervised runs hold
    each assistant turn's text and no user or system text, the decoded
    masked runs hold every user and system text, and a supervised label is
    its input id. Returns the number of supervised tokens."""
    supervised = 0
    for row in rows:
        enc = transform(row)
        ids, labels = enc["input_ids"], enc["labels"]
        if len(ids) != len(labels) or any(lab not in (-100, i) for lab, i in zip(labels, ids)):
            raise AssertionError(f"{tag}: labels are not the ids or -100")
        runs = {True: [], False: []}
        start = 0
        for j in range(1, len(ids) + 1):
            if j == len(ids) or (labels[j] == -100) != (labels[start] == -100):
                runs[labels[start] != -100].append(tokenizer.decode(ids[start:j]))
                start = j
        sup, masked = "\n".join(runs[True]), "\n".join(runs[False])
        for msg in row["messages"]:
            own = msg["role"] == "assistant"
            if msg["content"] not in (sup if own else masked) or (
                    not own and msg["content"] in sup):
                raise AssertionError(f"{tag}: a {msg['role']} turn's text is "
                                     f"{'not ' if own else ''}supervised")
        supervised += sum(lab != -100 for lab in labels)
    return supervised


def tensors_digest(tensors):
    """Per tensor, on the card: (sum of its 32-bit words, their sum weighted
    by a position hash) in int64; any changed word changes the second."""
    out = []
    with torch.no_grad():
        for t in tensors:
            words = t.detach().contiguous().view(-1).view(torch.int32)
            s1 = torch.zeros((), dtype=torch.int64, device=t.device)
            s2 = torch.zeros((), dtype=torch.int64, device=t.device)
            for lo in range(0, words.numel(), 1 << 24):
                w = words[lo:lo + (1 << 24)].long()
                pos = torch.arange(lo, lo + w.numel(), device=t.device, dtype=torch.int64)
                s1 += w.sum()
                s2 += (w * ((pos * 2654435761) % 2147483647 + 1)).sum()
            out.append((int(s1), int(s2)))
    return out


def sft_args(model_dir: str, weights: str, data: str, out: str, steps: int, *extra):
    """``configs/text/lora_sft.yaml`` with its paths pointed at ``model_dir``
    (config.json and the tokenizer files), ``weights`` and ``data``, run for
    ``steps`` steps with a log line each."""
    from veomni_tpu_torch.arguments import VeOmniArguments, parse_args

    return parse_args(VeOmniArguments, [
        SFT_YAML, f"--model.config_path={model_dir}", f"--model.model_path={weights}",
        f"--data.train_path={data}", f"--train.output_dir={out}",
        f"--train.train_steps={steps}", "--train.log_steps=1", *extra])


def sft_record():
    """A trainer callback recording per step the loss, grad norm and host
    time, and the first batch as the loop shipped it."""
    from veomni_tpu_torch.trainer.callbacks import Callback

    class Record(Callback):
        def __init__(self):
            self.steps, self.first_batch = {}, None

        def on_step_begin(self, trainer, state):
            if self.first_batch is None:
                self.first_batch = {k: v.copy() for k, v in trainer.current_batch.items()}

        def on_step_end(self, trainer, state):
            m = state.metrics
            self.steps[state.global_step] = dict(loss=float(m["loss"]),
                                                 grad_norm=float(m["grad_norm"]),
                                                 t=time.perf_counter())

    return Record()


def sft_run(dev, card, tag: str, args, steps: int, *, keep_checkpoints: bool = True):
    """``TextTrainer`` on ``args`` with an ``sft_record``: returns (trainer,
    the record, launches, fallbacks, peak bytes, the initial adapters, the
    base digest before) after logging each step; under LoRA every adapter's
    B must have moved off 0."""
    from veomni_tpu_torch.trainer import TextTrainer
    from veomni_tpu_torch.trainer.callbacks import CheckpointCallback
    from veomni_tpu_torch.utils.count_flops import FlopsCounter
    from veomni_tpu_torch.utils.device import get_device_peak_flops

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    trainer = TextTrainer(args)
    build_s = time.perf_counter() - t0
    if not keep_checkpoints:
        trainer.callbacks = [cb for cb in trainer.callbacks
                             if not isinstance(cb, CheckpointCallback)]
    rec = sft_record()
    trainer.callbacks.append(rec)
    base = trainer.base_model if trainer.base_model is not None else trainer.train_state.model
    init = {k: v.detach().clone() for k, v in trainer.train_state.model.state_dict().items()}
    before = tensors_digest(base.parameters()) if trainer.base_model is not None else None
    reset_all_counts()
    trainer.train()
    launches, fallbacks = read_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    if trainer.base_model is not None:
        # B starts at 0: an adapter the forward never reads keeps it there
        adapters = trainer.train_state.model
        idle = [p for p in adapters.paths if not adapters.leaf(p).lora_b.any()]
        if idle:
            raise AssertionError(f"{tag}: adapters that never trained: {idle}")
        log(f"{tag}: all {len(adapters.paths)} adapted leaves trained (B moved off 0)")
    cfg = base.cfg
    a = rec.steps
    check_steps([dict(loss=r["loss"], grad_norm=r["grad_norm"], step_ok=True)
                 for r in a.values()], tag)
    tokens = SFT_MICRO_BS * SFT_SEQ
    flops = FlopsCounter.from_config(cfg).batch_flops(tokens, SFT_SEQ)
    peak_flops = get_device_peak_flops(dev)
    ms = [(a[i]["t"] - a[i - 1]["t"]) * 1e3 for i in range(2, steps + 1)]
    for i in range(1, steps + 1):
        extra = (f" step_ms={ms[i - 2]:.1f} tokens_per_s={tokens / ms[i - 2] * 1e3:.1f}"
                 if i >= 2 else " (first step: warm-up, not timed)")
        log(f"{tag} step {i}: loss={a[i]['loss']:.6f} grad_norm={a[i]['grad_norm']:.6f}"
            f"{extra} [{card}]")
    if ms:
        med = sorted(ms)[len(ms) // 2]
        n_train = sum(p.numel() for p in trainer.train_state.model.parameters())
        log(f"{tag}: built in {build_s:.1f} s; warm steps 2-{steps} "
            f"{', '.join(f'{x:.1f}' for x in ms)} ms, median {med:.1f} ms, "
            f"{tokens / med * 1e3:.1f} tokens/s (packed rows), MFU "
            f"{flops / (med / 1e3) / peak_flops:.4f} (the model's FlopsCounter, which counts "
            f"no adapter work); {n_train} trained parameters; peak device memory "
            f"{peak / 2**30:.2f} GiB [{card}]")
    return trainer, rec, launches, fallbacks, peak, init, before


def sft_parity(dev, tag: str, args, init, before, first, trainer_step, pins):
    """The trainer's step 1 against the same weights, adapters and batch
    with the ops pinned as ``pins`` says: the base read from the HF
    directory, or drawn from the trainer's seed (its digest must equal the
    trainer's base's); returns (rel loss, rel grad norm) after logging
    them; the pinned op's kernels must stay idle in that leg."""
    from veomni_tpu_torch.lora import (
        LoraAdapters,
        LoraConfig,
        apply_lora_to_loss_fn,
        init_lora_params,
    )
    from veomni_tpu_torch.models import Transformer
    from veomni_tpu_torch.models.auto import build_foundation_model
    from veomni_tpu_torch.ops.kernel_registry import apply_ops_config
    from veomni_tpu_torch.optim import build_optimizer
    from veomni_tpu_torch.train import build_train_state, build_train_step
    from veomni_tpu_torch.utils.helper import set_seed

    m, t = args.model, args.train
    fm = build_foundation_model(m.config_path, ops_implementation=pins,
                                dtype=t.compute_dtype, param_dtype=t.param_dtype,
                                remat=t.enable_gradient_checkpointing,
                                remat_policy=t.gradient_checkpointing_policy,
                                **m.config_overrides)
    if m.model_path:
        base = fm.load_hf(m.model_path, device=dev)
    else:
        base = fm.init(set_seed(t.seed, dev), device=dev)
    if tensors_digest(base.parameters()) != before:
        raise AssertionError(f"{tag}: the pinned leg's base is not the trainer's")
    adapters = init_lora_params(None, base, LoraConfig.from_dict(m.lora))
    adapters.load_state_dict(init)
    state = build_train_state(adapters, build_optimizer(adapters, lr=1e-4))
    batch = {k: torch.from_numpy(v).to(dev) for k, v in first.items()}
    reset_all_counts()
    try:
        _, m = build_train_step(apply_lora_to_loss_fn(Transformer.loss_fn, base),
                                scope=LoraAdapters.merged)(state, batch)
    finally:
        apply_ops_config(None)
    plain = {k: float(m[k]) for k in ("loss", "grad_norm")}
    launched, _ = read_counts()
    rel = {k: abs(trainer_step[k] - plain[k]) / abs(plain[k]) for k in plain}
    log(f"{tag} step-1 parity against {pins}: " + "; ".join(
        f"{k} {trainer_step[k]:.6f} vs {plain[k]:.6f} (rel {rel[k]:.2e})" for k in plain)
        + f"; the pinned leg launched {launched}")
    # the pinned op's kernels must stay idle (the other op keeps its own)
    family = {"attention": "flash_", "group_gemm": "gmm_"}
    if any(n for k, n in launched.items() if any(k.startswith(family[op]) for op in pins)):
        raise AssertionError(f"{tag}: the pinned leg launched kernels: {launched}")
    del fm, base, adapters, state, batch, m
    gc.collect()
    torch.cuda.empty_cache()
    return rel


def check_adapter_round_trip(dev, tag: str, trainer, out_dir: str):
    """save_adapter, then load_adapter into fresh adapters: bit-equal.
    Returns (bytes, save s, load s)."""
    from veomni_tpu_torch.lora import init_lora_params, load_adapter, save_adapter
    from veomni_tpu_torch.lora.lora import ADAPTER_WEIGHTS

    live = trainer.train_state.model
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    save_adapter(live, trainer.lora_config, out_dir)
    save_s = time.perf_counter() - t0
    fresh = init_lora_params(None, trainer.base_model, trainer.lora_config)
    t0 = time.perf_counter()
    load_adapter(out_dir, fresh)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    bad = [n for (n, x), (_, y) in zip(fresh.named_jax_parameters(), live.named_jax_parameters())
           if not (x.dtype == y.dtype and torch.equal(x, y))]
    nbytes = os.path.getsize(os.path.join(out_dir, ADAPTER_WEIGHTS))
    log(f"{tag}: adapter ({len(live.paths)} adapted leaves, {nbytes / 1e6:.1f} MB) saved in "
        f"{save_s:.2f} s and loaded in {load_s:.2f} s: "
        f"{'bit-equal' if not bad else f'{len(bad)} tensors differ, e.g. {bad[:3]}'}")
    if bad:
        raise AssertionError(f"{tag}: adapter round trip differs")
    del fresh
    return nbytes, save_s, load_s


def check_merged_export(dev, tag: str, trainer, export_dir: str):
    """The merged HF export against W + scale * A @ B worked out here in f64
    from the live base and adapters: each adapted tensor within 2^-23 of
    |ref| plus 1e-5 of its largest |scale * A @ B| (f32 rounding of the add
    and of the rank-r product), every other tensor bit-equal to the base."""
    from veomni_tpu_torch.models import Transformer
    from veomni_tpu_torch.models.hf_io import hf_to_params

    base, adapters = trainer.base_model, trainer.train_state.model
    t0 = time.perf_counter()
    back = hf_to_params(export_dir, base.cfg, Transformer(base.cfg, None, device=dev))
    read_s = time.perf_counter() - t0
    adapted = {}
    for path in adapters.paths:
        seg, name = path.split(".", 1)
        leaf = adapters.leaf(path)
        for i, layer in enumerate(base.layers):
            adapted[f"layers.{i}.{name}"] = (leaf.lora_a[i], leaf.lora_b[i], leaf.scale)
    worst, exact = 0.0, 0
    with torch.no_grad():
        for (n, got), (_, w) in zip(back.named_parameters(), base.named_parameters()):
            if n not in adapted:
                if not torch.equal(got, w):
                    raise AssertionError(f"{tag}: {n} is not adapted, yet the export differs")
                exact += 1
                continue
            a, b, s = adapted[n]
            delta = (a.double() @ b.double()) * s.double()
            ref = w.double() + delta
            err = (got.double() - ref).abs()
            allow = 2.0 ** -23 * ref.abs() + 1e-5 * delta.abs().max()
            worst = max(worst, float((err / allow).max()))
    nbytes = sum(os.path.getsize(os.path.join(export_dir, f)) for f in os.listdir(export_dir))
    log(f"{tag}: merged HF export ({nbytes / 1e9:.3f} GB, read in {read_s:.1f} s): "
        f"{len(adapted)} adapted tensors within {worst:.3f} of the allowance against "
        f"W + scale * A @ B worked out here in f64, {exact} others bit-equal to the base")
    if not worst <= 1.0:
        raise AssertionError(f"{tag}: merged export departs from W + scale * A @ B ({worst})")
    del back
    return nbytes


def check_merged_layer(tag: str, trainer, index: int):
    """Layer ``index``'s merged weights, as the forward and the merged HF
    export read them (``DecoderLayer.w`` inside ``LoraAdapters.merged``),
    against W + scale * A @ B worked out here in f64 from the live base and
    adapters, with ``check_merged_export``'s allowance; expert tensors
    ([E, in, out] against A [E, in, r], B [E, r, out]) a slice of experts
    at a time. Returns the worst error over its allowance."""
    base, adapters = trainer.base_model, trainer.train_state.model
    layer = base.layers[index]
    worst, names = 0.0, []
    with torch.no_grad(), adapters.merged():
        for path in adapters.paths:
            seg, name = path.split(".", 1)
            if seg != "layers":
                continue
            leaf, w = adapters.leaf(path), layer.get_parameter(name)
            got = layer.w(name)
            # a per-layer vector's adapter has an unstacked B (_merge_layer)
            a, b = leaf.lora_a[index], leaf.lora_b[index] if w.ndim > 1 else leaf.lora_b
            s = leaf.scale.double()
            step = 16 if w.ndim == 3 else w.shape[0]
            for lo in range(0, w.shape[0], step):
                sl = slice(lo, lo + step) if w.ndim == 3 else slice(None)
                delta = (a[sl].double() @ b[sl].double()) * s
                ref = w[sl].double() + delta
                allow = 2.0 ** -23 * ref.abs() + 1e-5 * delta.abs().max()
                worst = max(worst, float(((got[sl].double() - ref).abs() / allow).max()))
                del delta, ref, allow
            if not bool(b.any()):
                raise AssertionError(f"{tag}: {path}'s B is still 0 at layer {index}")
            names.append(f"{name} {tuple(w.shape)}")
            del got
    log(f"{tag}: layer {index}'s merged weights ({', '.join(names)}) within {worst:.3f} of "
        f"the allowance against W + scale * A @ B worked out here in f64")
    if not worst <= 1.0:
        raise AssertionError(f"{tag}: layer {index}'s merged weights depart from "
                             f"W + scale * A @ B ({worst})")
    return worst


def phase_sft_lora_dense(dev, card):
    """TinyLlama-1.1B (the published config.json, random bf16 weights from
    seed 0 in an HF directory with the byte-fallback fixture tokenizer) at
    ``lora_sft.yaml``'s knobs: LoRA rank 16, alpha 32, conversation data at
    seq 4096 x micro-batch 2, lr 1e-4, the default ``nothing`` remat, 4
    steps with the llama2 template; then the parameter-group leg. Returns
    the LoRA run's launches."""
    from veomni_tpu_torch.data.data_transform import build_data_transform
    from veomni_tpu_torch.models.auto import build_tokenizer
    from veomni_tpu_torch.parallel.parallel_state import destroy_parallel_state

    tag = "sft lora dense TinyLlama-1.1B"
    tmp = tempfile.mkdtemp(prefix="chip_smoke_sft_dense_")
    try:
        t0 = time.perf_counter()
        hf_dir = os.path.join(tmp, "hf")
        cfg = write_random_hf_dir(dev, hf_dir, HF_PRESET)
        for name in ("tokenizer.json", "tokenizer_config.json"):
            shutil.copy(os.path.join(TOKENIZER_FIXTURES, "bytefallback", name), hf_dir)
        data = os.path.join(tmp, "chat.jsonl")
        sft_conversations(data, SFT_ROWS)
        log(f"{tag}: HF directory (random bf16 weights, the byte-fallback fixture tokenizer) "
            f"and {SFT_ROWS} conversations from the repo's docs written in "
            f"{time.perf_counter() - t0:.1f} s")
        # the label mask, with the llama2 template and the tokenizer's own
        # jinja template (TinyLlama-Chat's, turns ending in </s>)
        tok = build_tokenizer(hf_dir)
        with open(data) as f:
            rows = [json.loads(line) for line in f][:48]
        for template in ("llama2", "default"):
            transform = build_data_transform("conversation", tokenizer=tok, chat_template=template)
            t0 = time.perf_counter()
            n = check_label_mask(tok, transform, rows, f"{tag} {template} template")
            log(f"{tag}: the {template} template's labels mask every non-assistant token of "
                f"{len(rows)} rows ({n} supervised tokens, rendered and checked in "
                f"{time.perf_counter() - t0:.2f} s)")

        out = os.path.join(tmp, "out")
        args = sft_args(hf_dir, hf_dir, data, out, SFT_DENSE_STEPS,
                        "--data.chat_template=llama2")
        if (args.model.lora, args.data.max_seq_len, args.train.micro_batch_size) != (
                {"rank": 16, "alpha": 32}, SFT_SEQ, SFT_MICRO_BS):
            raise AssertionError(f"{tag}: {SFT_YAML} no longer sets the knobs this phase runs")
        trainer, rec, launches, fallbacks, _, init, before = sft_run(
            dev, card, tag, args, SFT_DENSE_STEPS)
        # remat "nothing" (the YAML's default): backward reruns each layer,
        # K1 included
        n = cfg.num_hidden_layers * SFT_DENSE_STEPS
        want = {"flash_fwd": 2 * n, "flash_bwd_dkv": n, "flash_bwd_dq": n}
        log(f"{tag}: launches {launches} (reckoned: {want}: per layer and step K1 twice, "
            f"forward and its recompute, K2 and K3 once), FALLBACK_CALLS {fallbacks}")
        check_counts(launches, fallbacks, want, tag)
        after = tensors_digest(trainer.base_model.parameters())
        if after != before:
            raise AssertionError(f"{tag}: the frozen base changed in training")
        log(f"{tag}: all {len(before)} base tensors bit-unchanged after {SFT_DENSE_STEPS} "
            f"steps (word-sum digests)")
        ckpt = os.path.join(out, "checkpoints", f"global_step_{SFT_DENSE_STEPS}", "train_state")
        ck_bytes = sum(os.path.getsize(os.path.join(ckpt, f)) for f in os.listdir(ckpt))
        log(f"{tag}: the checkpoint holds the adapters and their AdamW state alone: "
            f"{ck_bytes / 1e6:.1f} MB")
        check_adapter_round_trip(dev, tag, trainer, os.path.join(tmp, "adapter"))
        check_merged_export(dev, tag, trainer, os.path.join(out, "hf_ckpt"))
        first = rec.first_batch
        step1 = rec.steps[1]
        trainer.checkpointer.close()
        del trainer
        destroy_parallel_state()
        gc.collect()
        torch.cuda.empty_cache()
        rel = sft_parity(dev, tag, args, init, before, first, step1, {"attention": "xla"})
        # the adapters' grad norm is held like every grad norm of a kernel
        # leg against its plain one (TOL_GRAD_NORM_REL): over 22 bf16 layers
        # it read 7.38e-4 apart on an H100, where the loss read 2.08e-5
        if not (rel["loss"] <= TOL_LOSS_REL and rel["grad_norm"] <= TOL_GRAD_NORM_REL):
            raise AssertionError(f"{tag}: step 1 departs from the plain attention's ({rel})")
        phase_sft_param_groups(dev, card, hf_dir, data, tmp)
        return launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_sft_param_groups(dev, card, hf_dir: str, data: str, tmp: str):
    """The dense model fully fine-tuned with ``freeze_modules`` (the
    embedding) and ``module_lr_scales`` (0.1 on q/k/v/o), weight decay 0.1,
    no clip, 2 steps, against one plain step (no groups) on the same weights
    and batch: the frozen embedding bit-unchanged, the grad norm equal to
    the plain run's with the embedding's gradient zeroed (rel 1e-5), and the
    first update of the scaled tensors 0.1 x the plain run's (norm ratio rel
    1e-5, cosine within 1e-6 of 1), of the others 1 x."""
    from veomni_tpu_torch.models import Transformer
    from veomni_tpu_torch.models.auto import build_foundation_model
    from veomni_tpu_torch.optim import build_optimizer
    from veomni_tpu_torch.parallel.parallel_state import destroy_parallel_state
    from veomni_tpu_torch.train import build_train_state, build_train_step
    from veomni_tpu_torch.trainer import TextTrainer
    from veomni_tpu_torch.trainer.callbacks import Callback, CheckpointCallback

    tag = "sft param groups TinyLlama-1.1B"
    scaled = re.compile(next(iter(SFT_SCALES)))

    class FirstUpdate(Callback):
        """After step 1: each compared tensor's update."""

        def __init__(self, model):
            self.model = model
            self.start = {n: p.detach().clone() for n, p in self.compared()}
            self.update = None

        def compared(self):
            for n, p in self.model.named_parameters():
                parts = n.split(".")
                if (len(parts) == 3 and parts[2] in ("q_proj", "k_proj", "v_proj", "o_proj",
                                                     "down_proj")) or n == "lm_head":
                    yield n, p

        def on_step_end(self, trainer, state):
            if state.global_step == 1:
                self.update = {n: p.detach() - self.start[n] for n, p in self.compared()}
                self.start = None

    args = sft_args(hf_dir, hf_dir, data, os.path.join(tmp, "groups"), SFT_GROUPS_STEPS,
                    "--data.chat_template=llama2", "--train.max_grad_norm=0",
                    f"--train.weight_decay={SFT_GROUPS_DECAY}", "--train.save_hf_weights=false",
                    f"--model.freeze_modules={json.dumps(SFT_FREEZE)}",
                    f"--train.module_lr_scales={json.dumps(SFT_SCALES)}")
    args.model.lora = {}
    torch.cuda.empty_cache()
    trainer = TextTrainer(args)
    trainer.callbacks = [cb for cb in trainer.callbacks if not isinstance(cb, CheckpointCallback)]
    model = trainer.train_state.model
    embed_before = tensors_digest([model.embed_tokens])
    first = FirstUpdate(model)
    rec = sft_record()
    trainer.callbacks += [first, rec]
    groups = sorted(g["lr_scale"] for g in trainer.train_state.optimizer.param_groups)
    trainer.train()
    frozen_ok = tensors_digest([model.embed_tokens]) == embed_before
    upd_a = first.update
    trainer.checkpointer.close()
    del trainer, model, first
    destroy_parallel_state()
    gc.collect()
    torch.cuda.empty_cache()

    # the plain step: no groups, no clip, the same weights and batch
    t = args.train
    fm = build_foundation_model(hf_dir, weights_path=hf_dir, device=dev, dtype=t.compute_dtype,
                                param_dtype=t.param_dtype, remat=t.enable_gradient_checkpointing,
                                remat_policy=t.gradient_checkpointing_policy)
    model = fm.module
    start = {n: p.detach().clone() for n, p in model.named_parameters() if n in upd_a}
    state = build_train_state(model, build_optimizer(model, lr=t.lr, weight_decay=t.weight_decay))
    batch = {k: torch.from_numpy(v).to(dev) for k, v in rec.first_batch.items()}
    _, m = build_train_step(Transformer.loss_fn, max_grad_norm=0)(state, batch)
    with torch.no_grad():
        # the train step's own norm over the plain run's gradients, the
        # embedding's zeroed
        zeroed = [torch.zeros_like(p.grad) if n == "embed_tokens" else p.grad
                  for n, p in model.named_parameters()]
        want_norm = float(torch.linalg.vector_norm(torch.stack(torch._foreach_norm(zeroed))))
        got_norm = rec.steps[1]["grad_norm"]
        ratios = {}
        for n, p in model.named_parameters():
            if n not in upd_a:
                continue
            ub, ua = (p.detach() - start[n]).double(), upd_a[n].double()
            key = "scaled" if scaled.search(re.sub(r"^layers\.\d+\.", "layers.", n)) else "unscaled"
            r = ratios.setdefault(key, [0.0, 0.0, 0.0])
            r[0] += float((ua * ub).sum())
            r[1] += float((ua * ua).sum())
            r[2] += float((ub * ub).sum())
    rel_norm = abs(got_norm - want_norm) / want_norm
    summary = {k: (math.sqrt(r[1] / r[2]), r[0] / math.sqrt(r[1] * r[2])) for k, r in
               ratios.items()}
    log(f"{tag}: groups by lr scale {groups}; embedding bit-unchanged after "
        f"{SFT_GROUPS_STEPS} steps: {frozen_ok}; step-1 grad norm {got_norm:.6f} against the "
        f"plain run's without the embedding's gradient {want_norm:.6f} (rel {rel_norm:.2e}, "
        f"the plain run's whole norm {float(m['grad_norm']):.6f}); first update against the "
        f"plain run's: " + "; ".join(
            f"{k}: norm ratio {v[0]:.7f}, cosine {v[1]:.9f}" for k, v in summary.items())
        + f" [{card}]")
    want = {"scaled": 0.1, "unscaled": 1.0}
    if not (frozen_ok and rel_norm <= 1e-5 and set(summary) == set(want) and all(
            abs(summary[k][0] / want[k] - 1) <= 1e-5 and summary[k][1] >= 1 - 1e-6
            for k in want)):
        raise AssertionError(f"{tag}: parameter groups depart from the plain run")
    del fm, model, state, batch, m, start, upd_a
    gc.collect()
    torch.cuda.empty_cache()


def phase_sft_lora_moe(dev, card):
    """Qwen3-30B-A3B at its published widths, depth cut to SFT_MOE_LAYERS,
    random f32 weights from seed 0 (a model directory with the config.json
    and the byte-level fixture tokenizer, no weights), at ``lora_sft.yaml``'s
    knobs with ``moe_capacity_factor`` 2.0 at expert-parallel size 1, the
    chatml template, LoRA on the experts and attention, 4 steps. Returns its
    launches."""
    from veomni_tpu_torch.parallel.parallel_state import destroy_parallel_state
    from veomni_tpu_torch.train_text_step import bench_config

    tag = "sft lora moe Qwen3-30B-A3B"
    tmp = tempfile.mkdtemp(prefix="chip_smoke_sft_moe_")
    try:
        cfg = bench_config(MOE_PRESET, num_hidden_layers=SFT_MOE_LAYERS)
        model_dir = os.path.join(tmp, "model")
        os.makedirs(model_dir)
        with open(os.path.join(model_dir, "config.json"), "w") as f:
            json.dump(cfg.to_hf_config(), f, indent=2)
        for name in ("tokenizer.json", "tokenizer_config.json"):
            shutil.copy(os.path.join(TOKENIZER_FIXTURES, "bytelevel", name), model_dir)
        data = os.path.join(tmp, "chat.jsonl")
        sft_conversations(data, SFT_ROWS, seed=1)
        overrides = {"moe_capacity_factor": SFT_MOE_CAPACITY}
        args = sft_args(model_dir, "", data, os.path.join(tmp, "out"), SFT_MOE_STEPS,
                        "--data.chat_template=chatml", "--train.save_hf_weights=false",
                        f"--model.config_overrides={json.dumps(overrides)}")
        trainer, rec, launches, fallbacks, peak, init, before = sft_run(
            dev, card, tag, args, SFT_MOE_STEPS, keep_checkpoints=False)
        model_cfg = trainer.base_model.cfg
        widths = ("num_experts", "num_experts_per_tok", "hidden_size", "moe_intermediate_size",
                  "num_attention_heads", "num_key_value_heads", "head_dim", "vocab_size")
        if model_cfg.moe_capacity_factor != SFT_MOE_CAPACITY or any(
                getattr(model_cfg, k) != getattr(cfg, k) for k in widths):
            raise AssertionError(f"{tag}: the model is not the preset's widths at capacity "
                                 f"factor {SFT_MOE_CAPACITY}")
        adapted = sorted(trainer.train_state.model.paths)
        log(f"{tag}: {SFT_MOE_LAYERS} of 48 layers, capacity factor "
            f"{model_cfg.moe_capacity_factor} at expert-parallel size 1 (dropless), adapters "
            f"on {adapted}; peak {peak / 2**30:.2f} GiB")
        n = SFT_MOE_LAYERS * SFT_MOE_STEPS
        want = {"flash_fwd": 2 * n, "flash_bwd_dkv": n, "flash_bwd_dq": n,
                "gmm_fwd": 6 * n, "gmm_dlhs": 3 * n, "gmm_t": 3 * n}
        log(f"{tag}: launches {launches} (reckoned: {want}: per layer and step K1 twice, K2, "
            f"K3 once; K4 x 6 (gate, up, down on the merged experts, and their recompute), K5 "
            f"x 3, K6 x 3 (the merged experts' gradient, which flows into their adapters)), "
            f"FALLBACK_CALLS {fallbacks}")
        check_counts(launches, fallbacks, want, tag)
        after = tensors_digest(trainer.base_model.parameters())
        if after != before:
            raise AssertionError(f"{tag}: the frozen base changed in training")
        log(f"{tag}: all {len(before)} base tensors bit-unchanged after {SFT_MOE_STEPS} steps")
        check_adapter_round_trip(dev, tag, trainer, os.path.join(tmp, "adapter"))
        # the merged HF export is off in this leg: at 16 layers it would
        # write ~42 GB of f32; one MoE layer's merged experts are checked
        # through the read the export streams instead
        check_merged_layer(tag, trainer, SFT_MOE_LAYERS - 1)
        first, step1 = rec.first_batch, rec.steps[1]
        trainer.checkpointer.close()
        del trainer
        destroy_parallel_state()
        gc.collect()
        torch.cuda.empty_cache()
        rel = sft_parity(dev, tag, args, init, before, first, step1, {"group_gemm": "xla"})
        # the grad norm carries K6's merged-expert gradient into the adapters
        # (at step 1 every B is 0: the loss does not depend on them)
        if not (rel["loss"] <= TOL_LOSS_REL and rel["grad_norm"] <= TOL_GRAD_NORM_REL):
            raise AssertionError(f"{tag}: step 1 departs from the plain grouped GEMM's ({rel})")
        return launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# --------------------------------------------------------------------------
# Serving: the paged-KV engine at Qwen3-0.6B and Qwen3-30B-A3B
# --------------------------------------------------------------------------
# the post-training phase: the DPO, distillation and RL trainers through the
# classes their entry points (veomni_tpu_torch.tasks.train_text_{dpo,distill,
# rl}) build from the parsed YAML, and the channel loss through TextTrainer,
# at Qwen3-0.6B's full widths and 28 layers (the trainer phase's YAML:
# tools/trainer_profile.py); the LoRA DPO leg on TinyLlama-1.1B
POST_STEPS = 3
POST_LORA_STEPS = 2
POST_SEQ = 4096
DPO_PAIRS = 2  # pairs a micro-batch: 4 rows
POST_ROWS = 4  # distill and RL rows a micro-batch
DISTILL_TOPK = 8
CHANNELS = ("web", "code")
CHANNEL_STEPS = 2
# step 1's identities: DPO's loss is ln 2 a pair when policy and reference
# score alike (they run the same ops on the same weights: bit-equal, so the
# tolerance only allows for the f32 ln 2); the student is the teacher, so the
# KL is 0 and the two top-k masses agree up to the teacher's data passing
# through JSON (exact for f32) and the bf16 product shapes (a batch of 4
# rows against one); the RL ratio is 1 up to the same.
TOL_DPO_LN2 = 1e-5
TOL_KL = 1e-3
TOL_RATIO = 1e-2
TOL_CHANNEL_REL = 1e-5


def post_record(first=False):
    """A trainer callback recording each step's metrics (every step is a
    log step: host floats and arrays) and host time; ``first`` puts it ahead
    of the others (the channel loss callback pops its vectors)."""
    from veomni_tpu_torch.trainer.callbacks import Callback

    class Record(Callback):
        def __init__(self):
            self.steps = {}

        def on_step_end(self, trainer, state):
            self.steps[state.global_step] = dict(state.metrics, t=time.perf_counter(),
                                                 census=census_mark()[0])

        def on_train_end(self, trainer, state):  # the train-end eval
            if "eval_loss" in state.metrics:
                self.steps[state.global_step]["eval_loss"] = state.metrics["eval_loss"]

    return Record()


def post_run(dev, card, tag: str, cls, argv, steps: int, *, record_first=False, built=None):
    """``cls`` (the entry point's trainer) on the parsed ``argv``, its final
    checkpoint dropped (a 7 GB write nothing here reads), ``built(trainer)``
    called before it trains: returns (trainer, each step's metrics,
    launches, fallbacks) after logging the steps."""
    from veomni_tpu_torch.arguments import VeOmniArguments, parse_args
    from veomni_tpu_torch.trainer.callbacks import CheckpointCallback

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    trainer = cls(parse_args(VeOmniArguments, argv))
    build_s = time.perf_counter() - t0
    trainer.callbacks = [cb for cb in trainer.callbacks if not isinstance(cb, CheckpointCallback)]
    rec = post_record()
    if record_first:
        trainer.callbacks.insert(0, rec)
    else:
        trainer.callbacks.append(rec)
    if built is not None:
        built(trainer)
    reset_all_counts()
    t0 = time.perf_counter()
    trainer.train()
    train_s = time.perf_counter() - t0
    launches, fallbacks = read_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    a = rec.steps
    check_steps([dict(loss=r["loss"], grad_norm=r["grad_norm"], step_ok=r["step_ok"])
                 for r in a.values()], tag)
    ms = [(a[i]["t"] - a[i - 1]["t"]) * 1e3 for i in range(2, steps + 1)]
    extras = [k for k in ("dpo_acc", "distill_kl", "student_mass", "teacher_mass",
                          "ratio_mean", "eval_loss") if k in a[1] or k in a[steps]]
    for i in range(1, steps + 1):
        shown = " ".join(f"{k}={a[i][k]:.6f}" for k in extras if k in a[i])
        timing = (f" step_ms={ms[i - 2]:.1f}" if i >= 2
                  else " (first step: warm-up, not timed)")
        passes = a[i]["census"] - (a[i - 1]["census"] if i >= 2 else a[i]["census"])
        if passes:  # a new bucket's first call: an eval step's, say
            timing += f" ({passes} census counting passes inside)"
        log(f"{tag} step {i}: loss={a[i]['loss']:.6f} grad_norm={a[i]['grad_norm']:.6f} "
            f"ntokens={int(a[i]['ntokens'])} {shown}{timing} [{card}]")
    med = sorted(ms)[len(ms) // 2] if ms else float("nan")
    rows = trainer.args.train.micro_batch_size * (2 if cls.__name__ == "TextDPOTrainer" else 1)
    seq = trainer.args.data.max_seq_len
    log(f"{tag}: built in {build_s:.1f} s, {steps} steps in {train_s:.1f} s; warm steps "
        f"{', '.join(f'{x:.1f}' for x in ms)} ms, median {med:.1f} ms, "
        f"{rows * seq / med * 1e3:.1f} tokens/s ({rows} rows of {seq}, padding included), "
        f"peak device memory {peak / 2**30:.2f} GiB; launches {launches}, "
        f"FALLBACK_CALLS={fallbacks} [{card}]")
    return trainer, a, launches, fallbacks


def initial_policy(cfg_path: str, out: str):
    """The post-training trainers' initial model: the one a trainer builds
    from the YAML at ``cfg_path`` (its config and its seed), on the card."""
    from veomni_tpu_torch.arguments import VeOmniArguments, parse_args
    from veomni_tpu_torch.parallel.parallel_state import destroy_parallel_state
    from veomni_tpu_torch.trainer import TextTrainer

    trainer = TextTrainer(parse_args(VeOmniArguments, [cfg_path, f"--train.output_dir={out}"]))
    model = trainer.train_state.model
    trainer.checkpointer.close()
    del trainer
    destroy_parallel_state()
    gc.collect()
    return model


def params_digest(module):
    return tensors_digest(p for _, p in module.named_parameters())


def write_jsonl(path, rows):
    with open(path, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")


def row_logprobs(model, ids):
    """One row through ``model`` under ``no_grad`` (bf16 forward, f32
    logits 1024 positions at a time, as the trainers' fused CE takes them):
    per position t, log p(ids[t+1]) (t < n - 1) and the top-k ids and
    log-probs of the distribution at t."""
    dev = next(model.parameters()).device
    n = len(ids)
    with torch.no_grad():
        x = torch.tensor(ids, device=dev)[None]
        pos = torch.arange(n, device=dev)[None]
        seg = torch.ones_like(x, dtype=torch.int32)
        pad = (-n) % 128  # the flash kernels take S a multiple of 128
        if pad:
            x = torch.nn.functional.pad(x, (0, pad))
            pos = torch.nn.functional.pad(pos, (0, pad))
            seg = torch.nn.functional.pad(seg, (0, pad))
        hidden, _ = model.forward_hidden(x, pos, seg)
        kernel = model.lm_head_kernel().to(model.cfg.dtype).float()
        gold, top_ids, top_lp = [], [], []
        for lo in range(0, n, 1024):
            hi = min(lo + 1024, n)
            logits = hidden[0, lo:hi].float() @ kernel
            lse = torch.logsumexp(logits, dim=-1, keepdim=True)
            nxt = x[0, lo + 1:min(hi, n - 1) + 1]
            g = logits[: len(nxt)].gather(-1, nxt[:, None].long())[:, 0] - lse[: len(nxt), 0]
            v, i = torch.topk(logits, DISTILL_TOPK, dim=-1)
            gold.append(g)
            top_ids.append(i)
            top_lp.append(v - lse)
        return (torch.cat(gold).cpu().tolist(), torch.cat(top_ids).cpu().tolist(),
                torch.cat(top_lp).cpu().tolist())


def post_yaml_args(cfg_path: str, out: str, *extra):
    return [cfg_path, f"--train.output_dir={out}", f"--train.train_steps={POST_STEPS}", *extra]


def phase_post_training(dev, card):
    """The post-training trainers (see phase 20 of the module docstring).
    Returns {path: (launches, head dim, layout)} for the kernels line."""
    from veomni_tpu_torch.parallel.parallel_state import destroy_parallel_state
    from veomni_tpu_torch.tools.trainer_profile import write_config

    tmp = tempfile.mkdtemp(prefix="chip_smoke_post_")
    was_deterministic = torch.are_deterministic_algorithms_enabled()
    paths = {}
    try:
        cfg_path = write_config(tmp, steps=POST_STEPS)
        rng = np.random.default_rng(0)
        init = initial_policy(cfg_path, os.path.join(tmp, "init"))
        before = params_digest(init)
        layers, vocab = init.cfg.num_hidden_layers, init.cfg.vocab_size
        s = POST_SEQ

        # ---- data: DPO pairs, distillation rows with the initial model as
        # teacher, RL rows with half their old log-probs from it
        def ids(lo, hi):
            return rng.integers(0, vocab, int(rng.integers(lo, hi + 1))).tolist()

        t0 = time.perf_counter()
        pairs = [{"prompt": ids(s // 16, s // 4), "chosen": ids(s // 16, 3 * s // 8),
                  "rejected": ids(s // 16, 3 * s // 8)}
                 for _ in range(DPO_PAIRS * POST_STEPS + 2 * DPO_PAIRS)]
        write_jsonl(os.path.join(tmp, "dpo.jsonl"), pairs[:DPO_PAIRS * POST_STEPS])
        write_jsonl(os.path.join(tmp, "dpo_eval.jsonl"), pairs[DPO_PAIRS * POST_STEPS:])
        distill = []
        for _ in range(POST_ROWS * POST_STEPS):
            row = ids(s // 2, s)
            _, top_ids, top_lp = row_logprobs(init, row)
            distill.append({"input_ids": row, "teacher_topk_ids": top_ids[:len(row) - 1],
                            "teacher_topk_log_probs": top_lp[:len(row) - 1]})
        write_jsonl(os.path.join(tmp, "distill.jsonl"), distill)
        rl = []
        for i in range(POST_ROWS * POST_STEPS):
            prompt, resp = ids(s // 32, s // 8), ids(s // 8, s // 2)
            row = {"prompt": prompt, "response": resp, "advantage": float(rng.standard_normal())}
            if i % 2:  # the rollout policy's log-probs: the initial one's
                gold, _, _ = row_logprobs(init, prompt + resp)
                row["old_logprobs"] = gold[len(prompt) - 1:]
            rl.append(row)
        write_jsonl(os.path.join(tmp, "rl.jsonl"), rl)
        del init, distill, rl
        torch.cuda.empty_cache()
        log(f"post-training data: {len(pairs)} DPO pairs (prompts {s // 16}-{s // 4} tokens, "
            f"chosen and rejected {s // 16}-{3 * s // 8}); {POST_ROWS * POST_STEPS} "
            f"distillation rows of {s // 2}-{s} tokens with the initial Qwen3-0.6B's "
            f"top-{DISTILL_TOPK} ids and log-probs (a no_grad forward); {POST_ROWS * POST_STEPS} "
            f"RL rows (prompts {s // 32}-{s // 8}, responses {s // 8}-{s // 2} tokens, "
            f"advantages from N(0, 1)), every other one with the initial policy's old "
            f"log-probs, the rest on the sentinel; written in "
            f"{time.perf_counter() - t0:.1f} s")

        # ---- 1. DPO, full parameters, with the eval loop
        from veomni_tpu_torch.trainer import DistillTrainer, RLTrainer, TextDPOTrainer, TextTrainer

        tag = "post dpo Qwen3-0.6B"
        trainer, a, launches, fallbacks = post_run(dev, card, tag, TextDPOTrainer, post_yaml_args(
            cfg_path, os.path.join(tmp, "dpo"), f"--data.train_path={tmp}/dpo.jsonl",
            f"--data.eval_path={tmp}/dpo_eval.jsonl", "--train.eval_steps=2",
            "--train.eval_batches=1", f"--train.micro_batch_size={DPO_PAIRS}"), POST_STEPS)
        rel = abs(a[1]["loss"] - math.log(2)) / math.log(2)
        log(f"{tag}: step 1 loss {a[1]['loss']!r} against ln 2 = {math.log(2)!r} (rel {rel:.2e}, "
            f"tol {TOL_DPO_LN2}), dpo_acc {a[1]['dpo_acc']}")
        if not (rel <= TOL_DPO_LN2 and a[1]["dpo_acc"] == 0.0):
            raise AssertionError(f"{tag}: step 1 is not ln 2 a pair with no pair right")
        if params_digest(trainer.reference) != before:
            raise AssertionError(f"{tag}: the reference policy is not the initial one")
        if params_digest(trainer.train_state.model) == before:
            raise AssertionError(f"{tag}: the policy did not move")
        evals = {i: r["eval_loss"] for i, r in a.items() if "eval_loss" in r}
        per_step = {"flash_fwd": 2 * layers, "flash_bwd_dkv": layers, "flash_bwd_dq": layers}
        eval_k1 = 2 * layers  # one eval micro-batch: policy and reference forwards
        want = {k: v * POST_STEPS for k, v in per_step.items()}
        want["flash_fwd"] += eval_k1 * len(evals)
        log(f"{tag}: evals inside train() at steps {sorted(evals)}: {evals}; launches {launches} "
            f"(reckoned {want}: per step K1 twice a layer, the policy's forward and the "
            f"reference's under no_grad, ctx remat reruns none, K2 and K3 once a layer; each "
            f"eval K1 twice a layer)")
        check_counts(launches, fallbacks, want, tag)
        if sorted(evals) != [2, POST_STEPS]:
            raise AssertionError(f"{tag}: evals at {sorted(evals)}")
        paths["dpo"] = (launches, 128, None)
        reset_all_counts()
        t0 = time.perf_counter()
        e1, e2 = trainer.evaluate(), trainer.evaluate()
        eval_s = (time.perf_counter() - t0) / 2
        e_launches, e_fallbacks = read_counts()
        log(f"{tag}: two evaluate() calls on the final weights: {e1!r}, {e2!r} (the last "
            f"train-time eval {evals[POST_STEPS]!r}); {eval_s:.2f} s each; launches {e_launches}")
        if not e1 == e2 == evals[POST_STEPS]:
            raise AssertionError(f"{tag}: evaluate() is not repeatable")
        check_counts(e_launches, e_fallbacks, {"flash_fwd": 2 * eval_k1}, f"{tag} eval")
        paths["dpo_eval"] = (e_launches, 128, None)
        log(f"{tag}: the reference policy's {len(before)} tensors bit-equal to the initial "
            f"ones after {POST_STEPS} steps; the policy's moved")
        del trainer
        destroy_parallel_state()
        gc.collect()
        torch.cuda.empty_cache()

        # ---- 2. DPO with LoRA on TinyLlama-1.1B, text through its tokenizer
        paths["dpo_lora"] = post_dpo_lora(dev, card, tmp)
        gc.collect()
        torch.cuda.empty_cache()

        # ---- 3. distillation: the student is the teacher at step 1
        tag = "post distill Qwen3-0.6B"
        trainer, a, launches, fallbacks = post_run(dev, card, tag, DistillTrainer, post_yaml_args(
            cfg_path, os.path.join(tmp, "distill"), f"--data.train_path={tmp}/distill.jsonl",
            f"--train.distill_topk={DISTILL_TOPK}"), POST_STEPS)
        if params_digest(trainer.train_state.model) == before:
            raise AssertionError(f"{tag}: the student did not move")
        gap = abs(a[1]["student_mass"] - a[1]["teacher_mass"])
        log(f"{tag}: step 1 distill_kl {a[1]['distill_kl']!r} nats a token (tol {TOL_KL}), "
            f"student_mass {a[1]['student_mass']!r} teacher_mass {a[1]['teacher_mass']!r} "
            f"(|gap| {gap:.2e}, tol {TOL_KL})")
        if not (abs(a[1]["distill_kl"]) <= TOL_KL and gap <= TOL_KL):
            raise AssertionError(f"{tag}: step 1 departs from the teacher")
        want = {k: layers * POST_STEPS for k in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")}
        check_counts(launches, fallbacks, want, tag)
        paths["distill"] = (launches, 128, None)
        del trainer
        destroy_parallel_state()
        gc.collect()
        torch.cuda.empty_cache()

        # ---- 4. RL: on-policy rows and the initial policy's old log-probs
        tag = "post rl Qwen3-0.6B"
        trainer, a, launches, fallbacks = post_run(dev, card, tag, RLTrainer, post_yaml_args(
            cfg_path, os.path.join(tmp, "rl"), f"--data.train_path={tmp}/rl.jsonl"), POST_STEPS)
        log(f"{tag}: step 1 ratio_mean {a[1]['ratio_mean']!r} (|ratio_mean - 1| tol "
            f"{TOL_RATIO}); later steps {[a[i]['ratio_mean'] for i in range(2, POST_STEPS + 1)]}")
        if not abs(a[1]["ratio_mean"] - 1) <= TOL_RATIO:
            raise AssertionError(f"{tag}: step 1's ratio departs from 1")
        check_counts(launches, fallbacks, want, tag)
        paths["rl"] = (launches, 128, None)
        del trainer
        destroy_parallel_state()
        gc.collect()
        torch.cuda.empty_cache()

        # ---- 5. the channel loss on the trainer phase's model and YAML
        tag = "post channel loss Qwen3-0.6B"
        corpus = [{"input_ids": ids(s // 16, s // 2), "channel": CHANNELS[i % 2]}
                  for i in range(128)]
        write_jsonl(os.path.join(tmp, "channels.jsonl"), corpus)
        trainer, a, launches, fallbacks = post_run(dev, card, tag, TextTrainer, [
            cfg_path, f"--train.output_dir={tmp}/channels", f"--train.train_steps={CHANNEL_STEPS}",
            f"--data.train_path={tmp}/channels.jsonl",
            f"--data.channel_list={json.dumps(list(CHANNELS))}"], CHANNEL_STEPS,
            record_first=True)
        for i, r in a.items():
            sums, counts = np.asarray(r["channel_loss_sums"]), np.asarray(r["channel_token_counts"])
            loss_sum = r["loss"] * r["ntokens"]
            rel = abs(sums.sum() - loss_sum) / loss_sum
            log(f"{tag} step {i}: per-channel sums {sums.tolist()} (sum {sums.sum():.4f}) "
                f"against the step's loss_sum {loss_sum:.4f} (rel {rel:.2e}, tol "
                f"{TOL_CHANNEL_REL}); counts {counts.tolist()} against ntokens "
                f"{int(r['ntokens'])}")
            if not (rel <= TOL_CHANNEL_REL and counts.sum() == r["ntokens"] and counts.min() > 0):
                raise AssertionError(f"{tag}: step {i}'s channel sums or counts do not add up")
        totals = next(cb for cb in trainer.callbacks if type(cb).__name__ == "ChannelLossCallback"
                      ).state_dict()
        log(f"{tag}: the callback's totals {totals}")
        want = {k: layers * CHANNEL_STEPS for k in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")}
        check_counts(launches, fallbacks, want, tag)
        paths["channel_loss"] = (launches, 128, None)
        del trainer
        destroy_parallel_state()
        return paths
    finally:
        torch.use_deterministic_algorithms(was_deterministic)
        shutil.rmtree(tmp, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()


DPO_LORA_YAML = """
model:
  config_path: {hf}
  model_path: {hf}
  tokenizer_path: {hf}
  lora: {{rank: 16, alpha: 32}}
data:
  train_path: {data}
  data_type: plaintext
  max_seq_len: {seq}
train:
  micro_batch_size: {pairs}
  train_steps: {steps}
  bf16: true
  param_dtype: float32
  enable_gradient_checkpointing: true
  gradient_checkpointing_policy: ctx
  lr: 1.0e-4
  seed: 0
  save_hf_weights: false
  prefetch_depth: 0
  log_steps: 1
"""


def post_dpo_lora(dev, card, tmp: str):
    """DPO with LoRA (rank 16, alpha 32: lora_sft.yaml's) on TinyLlama-1.1B
    from an HF directory of random bf16 weights (seed 0, the SFT phase's
    model) with the byte-fallback fixture tokenizer; prompt, chosen and
    rejected texts are paragraphs of the repo's docs, tokenized by the
    trainer. The reference policy is the bare base. Returns its launches."""
    from veomni_tpu_torch.parallel.parallel_state import destroy_parallel_state
    from veomni_tpu_torch.trainer import TextDPOTrainer

    tag = "post dpo lora TinyLlama-1.1B"
    hf_dir = os.path.join(tmp, "tinyllama")
    t0 = time.perf_counter()
    cfg = write_random_hf_dir(dev, hf_dir, HF_PRESET)
    for name in ("tokenizer.json", "tokenizer_config.json"):
        shutil.copy(os.path.join(TOKENIZER_FIXTURES, "bytefallback", name), hf_dir)
    paras = []
    for name in SFT_DOCS:
        with open(name, encoding="utf-8") as f:
            paras += [p.strip() for p in f.read().split("\n\n") if len(p.strip()) > 80]
    rng = np.random.default_rng(1)
    rows = []
    for _ in range(DPO_PAIRS * POST_LORA_STEPS):  # ~150-400 tokens each
        pick = rng.choice(len(paras), size=3, replace=False)
        rows.append({"prompt": paras[pick[0]][:600], "chosen": paras[pick[1]][:1200],
                     "rejected": paras[pick[2]][:1200]})
    data = os.path.join(tmp, "dpo_text.jsonl")
    write_jsonl(data, rows)
    yaml_path = os.path.join(tmp, "dpo_lora.yaml")
    with open(yaml_path, "w") as f:
        f.write(DPO_LORA_YAML.format(hf=hf_dir, data=data, seq=HF_SEQ, pairs=DPO_PAIRS,
                                     steps=POST_LORA_STEPS))
    log(f"{tag}: HF directory, tokenizer and {len(rows)} text pairs written in "
        f"{time.perf_counter() - t0:.1f} s")
    before = []

    def built(trainer):
        sample = trainer.data_transform(rows[0])
        n_prompt = sum(lab == -100 for lab in sample["chosen_labels"])
        n_chosen = len(sample["chosen_input_ids"]) - n_prompt
        n_rejected = len(sample["rejected_input_ids"]) - n_prompt
        log(f"{tag}: the first pair tokenizes to a {n_prompt}-token prompt (masked in both "
            f"branches), {n_chosen} chosen and {n_rejected} rejected tokens")
        if not (n_prompt and n_chosen and n_rejected):
            raise AssertionError(f"{tag}: a text pair lost its prompt or a response")
        before.extend(tensors_digest(trainer.base_model.parameters()))

    trainer, a, launches, fallbacks = post_run(dev, card, tag, TextDPOTrainer, [
        yaml_path, f"--train.output_dir={tmp}/dpo_lora"], POST_LORA_STEPS, built=built)
    rel = abs(a[1]["loss"] - math.log(2)) / math.log(2)
    log(f"{tag}: step 1 loss {a[1]['loss']!r} against ln 2 (rel {rel:.2e}, tol {TOL_DPO_LN2}); "
        f"the reference policy is the bare base: {trainer.reference is trainer.base_model}")
    if not (rel <= TOL_DPO_LN2 and trainer.reference is trainer.base_model):
        raise AssertionError(f"{tag}: step 1 is not ln 2 a pair against the bare base")
    if tensors_digest(trainer.base_model.parameters()) != before:
        raise AssertionError(f"{tag}: the frozen base changed in training")
    adapters = trainer.train_state.model
    idle = [p for p in adapters.paths if not adapters.leaf(p).lora_b.any()]
    if idle:
        raise AssertionError(f"{tag}: adapters that never trained: {idle}")
    n = cfg.num_hidden_layers * POST_LORA_STEPS
    want = {"flash_fwd": 2 * n, "flash_bwd_dkv": n, "flash_bwd_dq": n}
    check_counts(launches, fallbacks, want, tag)
    log(f"{tag}: base bit-unchanged ({len(before)} tensors), every adapter trained; launches "
        f"as reckoned {want} (all at D 64)")
    del trainer, adapters
    destroy_parallel_state()
    return launches, 64, None


SERVE_DENSE_PRESET = "qwen3_0p6b"
# the dense phase's five legs run 8 requests (16 until the parallel phase
# joined the script, 32 until the remat and int8 serving phases did), decode
# 64 new tokens a request and hold 3 prompts against greedy_generate (its
# contiguous loop); 128 and 8 until the gpt-oss phases joined the script:
# cut to keep the whole run near 1000 s of its 1200
SERVE_DENSE = dict(slots=16, block=16, max_model_len=4096, requests=8, wave=4, wave_ticks=4,
                   prompt=(64, 1536), shared_prefix=512, max_new=64)
SERVE_MOE = dict(slots=8, block=16, max_model_len=4096, requests=8, wave=4, wave_ticks=4,
                 prompt=(64, 1024), shared_prefix=0, max_new=64)
# 24 of Qwen3-30B-A3B's 48 layers (all 48 until the parallel phase ran through
# the trainer): a decode tick's time is its layers'
SERVE_MOE_LAYERS = 24
SERVE_CHUNK = 512
SERVE_GREEDY_PROMPTS = 3
SERVE_SPEC_K = 4
SERVE_SAMPLING = dict(temperature=0.8, top_k=50, top_p=0.9)
# The re-score gate: an engine token's logit may sit below its row's maximum
# in the f32 teacher-forced re-score by at most eps = EPS_FACTOR x the
# phase's recorded delta, a constant: delta is the largest |engine -
# re-score| over the vocabulary of the engine's first-token logits of every
# prompt of the phase (its contiguous prefill, in the compute dtype), as
# read on an NVIDIA H100 80GB HBM3 at this script's seeds. A greedy token's
# gap is at most twice its row's |engine - re-score| (it is the engine's
# argmax), so 2 x delta bounds rows like the recorded ones; EPS_FACTOR = 4
# leaves a factor 2 for rows whose error runs above the first tokens'
# (decode rows attend over a bf16 cache the prefill wrote). A sampled token
# must be in the re-score's top-k/top-p keep-set with the threshold lowered
# by eps / temperature. Each run measures delta again and fails above
# DELTA_CEILING x the recorded value: the contiguous prefill shares its layer
# functions with the paged steps, so a fault there shows in delta, while eps
# stays where the sound code put it.
# Gemma-3-1B's (0.0652) with its norm weights at 0 (``random_model``);
# gpt-oss-20b's (0.2445, a spread of its logits ~0.54) with its matrices at
# std 0.01 (``GPT_OSS_SERVE_STD``).
SERVE_DELTA = {"serve dense": 0.0481, "serve moe": 0.0917, "serve gemma3": 0.0652,
               "serve gpt_oss": 0.2445}
EPS_FACTOR = 4.0
DELTA_CEILING = 2.0


def serve_traffic(vocab: int, spec: dict, seed: int = 0):
    """Prompts of the phase from one numpy seed: lengths uniform in
    spec["prompt"]; every other request (from the first) carries one shared
    system prefix of spec["shared_prefix"] tokens ahead of its own."""
    rng = np.random.default_rng(seed)
    system = rng.integers(1, vocab, spec["shared_prefix"]).tolist()
    lo, hi = spec["prompt"]
    prompts = []
    for i in range(spec["requests"]):
        own = rng.integers(1, vocab, int(rng.integers(lo, hi + 1))).tolist()
        prompts.append((system if i % 2 == 0 else []) + own)
    return prompts


def shared_blocks(prompts, block: int):
    """Per prompt, the tokens of the longest block-aligned prefix it shares
    with any other prompt: all a prefix cache may serve it."""
    out = []
    for i, p in enumerate(prompts):
        best = 0
        for j, q in enumerate(prompts):
            if i != j:
                n = 0
                while n < min(len(p), len(q)) and p[n] == q[n]:
                    n += 1
                best = max(best, n)
        out.append(best // block * block)
    return out


@contextlib.contextmanager
def f32_rescore(model):
    """The model's training forward in f32 (every compute-dtype cast of the
    weights an f32 one) with the plain attention and grouped GEMM pinned:
    a path that shares no code with the paged decode."""
    from veomni_tpu_torch.ops.kernel_registry import apply_ops_config

    cfg = model.cfg
    modules = [model, *model.layers]
    f32 = dataclasses.replace(cfg, dtype=torch.float32)
    for m in modules:
        m.cfg = f32
    apply_ops_config({"attention": "xla", "group_gemm": "xla"})
    try:
        with torch.no_grad():
            yield
    finally:
        apply_ops_config(None)
        for m in modules:
            m.cfg = cfg


def rescore_rows(model, ids, first: int):
    """f32 logits [len(ids) - first, V]: row j is the next-token
    distribution after ids[:first + j] (teacher forcing), with the config's
    final softcap. Call under f32_rescore."""
    dev = model.embed_tokens.device
    t = torch.tensor(ids, device=dev)[None]
    hidden, _ = model.forward_hidden(t, torch.arange(len(ids), device=dev)[None])
    logits = hidden[0, first - 1:len(ids) - 1].float() @ model.lm_head_kernel().float()
    cap = model.cfg.final_logit_softcap
    return cap * torch.tanh(logits / cap) if cap else logits


def first_token_spread(model, cfg, compute, prompts, tag):
    """delta: the largest |engine - re-score| over the vocabulary of the
    first-token logits of every prompt (the engine's contiguous prefill).
    Returns (delta, eps, ceiling) with eps and the ceiling from the phase's
    recorded delta."""
    from veomni_tpu_torch.models import decode as tdec

    dev = model.embed_tokens.device
    t0 = time.perf_counter()
    engine_rows = []
    for p in prompts:
        pb = tdec._bucket_pow2(len(p), floor=16)
        tokens = torch.zeros((1, pb), dtype=torch.long, device=dev)
        tokens[0, :len(p)] = torch.tensor(p, device=dev)
        engine_rows.append(tdec.prefill(compute, cfg, tokens, len(p), pb, pb)[0][0])
    spreads = []
    with f32_rescore(model):
        for p, row in zip(prompts, engine_rows):
            # a placeholder next token: causal rows before it do not see it
            spreads.append((row - rescore_rows(model, p + [0], len(p))[0]).abs().max().item())
    delta = max(spreads)
    recorded = SERVE_DELTA[tag]
    eps, ceiling = EPS_FACTOR * recorded, DELTA_CEILING * recorded
    log(f"{tag}: first-token logits, engine (bf16 contiguous prefill) vs f32 re-score over "
        f"{len(prompts)} prompts: max |diff| median {sorted(spreads)[len(spreads) // 2]:.4f}, "
        f"max {delta:.4f} (ceiling {DELTA_CEILING:g} x the recorded {recorded:.4f} = "
        f"{ceiling:.4f}); eps = {EPS_FACTOR:g} x {recorded:.4f} = {eps:.4f} "
        f"({time.perf_counter() - t0:.1f} s)")
    return delta, eps, ceiling


def keep_floor(scaled, top_k: int, top_p: float):
    """Per row of temperature-scaled logits [R,V], the least logit of its
    sampling keep-set [R]: the top_k largest, then the shortest prefix of
    them (renormalised, in f64) whose mass before each member is below
    top_p."""
    top = torch.sort(scaled.double(), dim=-1, descending=True).values[:, :top_k]
    prob = torch.softmax(top, dim=-1)
    before = torch.cumsum(prob, dim=-1) - prob
    count = torch.clamp_min((before < top_p).sum(-1), 1)
    return top.gather(1, (count - 1)[:, None])[:, 0]


def rescore_gate(model, prompts, outs, sampling, eps):
    """Worst ratio over every emitted token: greedy, (row max - token's
    logit) / eps; sampled, (keep floor - token's scaled logit) /
    (eps / temperature), both floored at 0. Returns (ratio, tokens held)."""
    worst, n = 0.0, 0
    with f32_rescore(model):
        for p, out in zip(prompts, outs):
            ids = p + out.token_ids
            rows = rescore_rows(model, ids, len(p))
            tok = torch.tensor(out.token_ids, device=rows.device)
            mine = rows.gather(1, tok[:, None])[:, 0]
            if sampling.get("temperature", 0.0) > 0:
                temp = sampling["temperature"]
                below = keep_floor(rows / temp, sampling["top_k"], sampling["top_p"]) - mine / temp
                worst = max(worst, (below.clamp_min(0) / (eps / temp)).max().item())
            else:
                worst = max(worst, ((rows.max(-1).values - mine) / eps).max().item())
            n += len(out.token_ids)
    return worst, n


def host_state(tag):
    """Log what earlier phases leave in this process that a host-bound
    serving tick can feel: threads, span tracing, deterministic algorithms,
    the objects the garbage collector tracks."""
    from veomni_tpu_torch.observability import spans

    threads = sorted(t.name for t in threading.enumerate() if t is not threading.main_thread())
    log(f"{tag}: host state: threads besides main {threads}; spans "
        f"{'on' if spans.spans_enabled() else 'off'}; deterministic algorithms "
        f"{torch.are_deterministic_algorithms_enabled()}; torch threads "
        f"{torch.get_num_threads()}; {len(gc.get_objects())} objects tracked by gc")
    if spans.spans_enabled():
        # left on by the trainer phases before (their observability default);
        # a serving process has no trainer: its ticks run without span tracing
        spans.disable_spans()
        log(f"{tag}: span tracing turned off for the serving phase")


def pool_ptrs(eng):
    """Where an engine's pools lie: the dense tensors', or an int8 pool's
    payload and scale."""
    return tuple(t.data_ptr() for pool in (eng.k_pool, eng.v_pool)
                 for t in ((pool,) if isinstance(pool, torch.Tensor) else (pool.data, pool.scale)))


def census_mark():
    """(counting passes, their seconds) of the cost census so far: a timed
    span takes one before it and names what fell inside with
    ``census_note``."""
    from veomni_tpu_torch.observability.cost import get_cost_census

    progs = get_cost_census().programs()
    return sum(p.traces for p in progs), sum(p.compile_time_s for p in progs)


def census_note(mark) -> str:
    """The census's counting passes since ``mark``: each is a bucket's first
    call, slower by its count (``observability/cost.py``)."""
    n, secs = census_mark()
    return f"{n - mark[0]} census counting passes inside ({secs - mark[1]:.2f} s)"


def serve_leg(model, cfg, dev, card, prompts, spec, tag, *, prefix_cache=True,
              chunk=SERVE_CHUNK, spec_k=0, sampling=None, kv_quant="none", weight_quant="none"):
    """One engine run over the phase's traffic: two waves, the second
    ``wave_ticks`` ticks after the first. Returns (outputs in submit order,
    stats) with every kernel launch counter set to 0 just before the engine
    is driven and read just after."""
    from veomni_tpu_torch.serving import EngineConfig, InferenceEngine, Request, SamplingParams

    sampling = sampling or {}
    eng = InferenceEngine(model, cfg, EngineConfig(
        num_slots=spec["slots"], block_size=spec["block"], max_model_len=spec["max_model_len"],
        prefix_cache=prefix_cache, prefill_chunk=chunk, spec_k=spec_k, kv_quant=kv_quant,
        weight_quant=weight_quant), device=dev)
    ptrs = pool_ptrs(eng)
    reqs = [Request(prompt_ids=p, sampling=SamplingParams(
        max_new_tokens=spec["max_new"], seed=i, **sampling)) for i, p in enumerate(prompts)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_all_counts()
    eng.metrics()  # opens the throughput window
    # host time the leg spends in the garbage collector, and the device
    # allocations the caching allocator makes (cudaMalloc) during the leg
    gc_spent = {"s": 0.0, "n": 0, "full": 0, "t": None}

    def on_gc(phase, info):
        if phase == "start":
            gc_spent["t"] = time.perf_counter()
        elif gc_spent["t"] is not None:
            gc_spent["s"] += time.perf_counter() - gc_spent["t"]
            gc_spent["n"] += 1
            gc_spent["full"] += info["generation"] == 2

    mallocs = torch.cuda.memory_stats(dev).get("num_device_alloc", 0)
    gc.callbacks.append(on_gc)
    census = census_mark()
    t0 = time.perf_counter()
    try:
        ids = [eng.submit(r) for r in reqs[:spec["wave"]]]
        ticks = 0
        for _ in range(spec["wave_ticks"]):
            eng.step()
            ticks += 1
        ids += [eng.submit(r) for r in reqs[spec["wave"]:]]
        while eng.has_work:
            eng.step()
            ticks += 1
        torch.cuda.synchronize()
    finally:
        gc.callbacks.remove(on_gc)
    wall = time.perf_counter() - t0
    mallocs = torch.cuda.memory_stats(dev).get("num_device_alloc", 0) - mallocs
    launches, fallbacks = read_counts()
    m = eng.metrics()
    outs = eng.run()
    outs = [outs[i] for i in ids]
    bm = eng.blocks
    ttft = sorted(o.ttft_s for o in outs)
    tpot = sorted(o.tpot_s for o in outs if o.tpot_s is not None)
    stats = dict(
        wall_s=wall, ticks=ticks, generated=int(m["generated_tokens"]),
        decode_tokens_per_s=m["decode_tokens_per_sec"],
        ttft_p50_s=ttft[len(ttft) // 2], ttft_p99_s=ttft[min(len(ttft) - 1,
                                                             int(0.99 * len(ttft)))],
        tpot_median_ms=1e3 * tpot[len(tpot) // 2] if tpot else float("nan"),
        prefix_hit_rate=m["prefix_hit_rate"], spec_proposed=int(m["spec_proposed"]),
        spec_accepted=int(m["spec_accepted"]),
        spec_acceptance=m["spec_accepted"] / max(1.0, m["spec_proposed"]),
        prefill_chunks=int(m["prefill_chunks"]), decode_steps=eng.decode_steps,
        kv_pool_bytes=eng.kv_capacity()["pool_bytes"],
        max_concurrent_seqs=int(eng.kv_capacity()["max_concurrent_seqs"]),
        peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30,
        launches=launches, fallbacks=fallbacks, preemptions=eng.scheduler.preemption_count,
        leak_free=(bm.num_used == 0
                   and bm.num_free_uncached + bm.num_cached == bm.num_blocks - 1),
        pools_fixed=pool_ptrs(eng) == ptrs,
        block_bytes=eng.kv_capacity()["block_bytes"],
        cached_tokens=[o.cached_tokens for o in outs],
        gc_s=gc_spent["s"], gc_collections=gc_spent["n"], gc_full=gc_spent["full"],
        device_mallocs=mallocs,
    )
    log(f"{tag}: {len(outs)} requests, {stats['generated']} tokens in {ticks} ticks, "
        f"{wall:.2f} s; TTFT p50 {stats['ttft_p50_s'] * 1e3:.1f} ms p99 "
        f"{stats['ttft_p99_s'] * 1e3:.1f} ms; TPOT median {stats['tpot_median_ms']:.2f} ms; "
        f"decode {stats['decode_tokens_per_s']:.1f} tok/s; prefix hit rate "
        f"{stats['prefix_hit_rate']:.4f}; spec accepted {stats['spec_accepted']}/"
        f"{stats['spec_proposed']} ({stats['spec_acceptance']:.4f}); prefill chunks "
        f"{stats['prefill_chunks']}, decode steps {stats['decode_steps']}, preemptions "
        f"{stats['preemptions']}; KV pool {stats['kv_pool_bytes'] / 2**30:.3f} GiB, "
        f"max_concurrent_seqs {stats['max_concurrent_seqs']}; peak "
        f"{stats['peak_gib']:.2f} GiB; host time in gc {stats['gc_s']:.3f} s over "
        f"{stats['gc_collections']} collections ({stats['gc_full']} full); cudaMalloc calls "
        f"{mallocs}; {census_note(census)}; launches {launches}, FALLBACK_CALLS {fallbacks} "
        f"[{card}]")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return outs, stats


def check_serve_leg(tag, model, prompts, outs, stats, spread, max_new, sampling=None,
                    allowed_cached=None, want_launches=None, gate=None):
    """Every check of one leg, all logged before the first failure raises.
    spread: the phase's (delta, eps, ceiling) from first_token_spread.
    ``gate``, where given, replaces the f32 re-score gate: a callable of
    (prompts, outs, eps) -> (worst ratio, tokens held), e.g. an int8 leg's
    own int8 re-score (``q8_rescore_gate``)."""
    delta, eps, ceiling = spread
    t0 = time.perf_counter()
    if gate is None:
        ratio, n = rescore_gate(model, prompts, outs, sampling or {}, eps)
    else:
        ratio, n = gate(prompts, outs, eps)
    checks = [("re-score gate", ratio <= 1.0,
               f"worst (gap / eps) = {ratio:.4f} over {n} tokens (eps = {eps:.4f}; "
               f"{time.perf_counter() - t0:.1f} s)"),
              ("first-token spread", delta <= ceiling,
               f"max |engine - re-score| {delta:.4f} / ceiling {ceiling:.4f} = "
               f"{delta / ceiling:.4f}")]
    checks.append(("block leak", stats["leak_free"], "free_uncached + cached == pool - null"))
    checks.append(("pool storage", stats["pools_fixed"], "k/v pools kept their storage"))
    if allowed_cached is not None:
        over = [(c, a) for c, a in zip(stats["cached_tokens"], allowed_cached) if c > a]
        checks.append(("prefix cache", not over,
                       f"cached tokens within each prompt's shared block-aligned prefix "
                       f"(over: {over[:3]})"))
    checks.append(("fallback", not any(stats["fallbacks"].values()),
                   f"FALLBACK_CALLS {stats['fallbacks']}"))
    want = want_launches or {}
    bad = {k: v for k, v in stats["launches"].items() if v != want.get(k, 0)}
    checks.append(("launches", not bad, f"launches {stats['launches']}, expected {want}"))
    checks.append(("lengths", all(len(o.token_ids) == max_new and o.finish_reason == "length"
                                  for o in outs), "every request finished at max_new_tokens"))
    for name, ok, what in checks:
        log(f"  {tag}: {name}: {'ok' if ok else 'FAILED'}: {what}")
    failed = [f"{name} ({what})" for name, ok, what in checks if not ok]
    if failed:
        raise AssertionError(f"{tag}: " + "; ".join(failed))
    return ratio


def match_share(a, b):
    return sum(x == y for x, y in zip(a, b)) / len(a)


def common_prefix(a, b):
    """Mean length of the common prefix of paired token lists: bf16 GEMMs of
    other shapes may flip a near-tie, after which a stream diverges."""
    total = 0
    for x, y in zip(a, b):
        n = 0
        while n < min(len(x), len(y)) and x[n] == y[n]:
            n += 1
        total += n
    return total / len(a)


def phase_serve_dense(dev, card):
    """The serving main path at Qwen3-0.6B, full width and depth: legs (a)
    prefix cache + chunked prefill, (b) cache off + monolithic prefill,
    (c) = (a) + ngram speculation, (d) (a) and (c) sampled."""
    from veomni_tpu_torch.models import Transformer
    from veomni_tpu_torch.models import decode as tdec
    from veomni_tpu_torch.train_text_step import SEED, bench_config

    host_state("serve dense")
    spec = SERVE_DENSE
    cfg = bench_config(SERVE_DENSE_PRESET, param_dtype="bfloat16")
    model = Transformer(cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev)
    prompts = serve_traffic(cfg.vocab_size, spec)
    allowed = shared_blocks(prompts, spec["block"])
    lens = [len(p) for p in prompts]
    log(f"serve dense: Qwen3-0.6B ({cfg.num_hidden_layers} layers, bf16 weights from seed "
        f"{SEED}), {spec['slots']} slots, block {spec['block']}, max_model_len "
        f"{spec['max_model_len']}; {len(prompts)} requests of {min(lens)}-{max(lens)} prompt "
        f"tokens ({len(prompts) // 2} behind one {spec['shared_prefix']}-token prefix), "
        f"{spec['max_new']} new tokens each, waves of {spec['wave']} [{card}]")
    spread = first_token_spread(model, cfg, tdec._compute_cast(model, cfg), prompts, "serve dense")
    legs = {}
    for leg, kw in (("a", {}), ("b", dict(prefix_cache=False, chunk=0)),
                    ("c", dict(spec_k=SERVE_SPEC_K)), ("d-a", dict(sampling=SERVE_SAMPLING)),
                    ("d-c", dict(spec_k=SERVE_SPEC_K, sampling=SERVE_SAMPLING))):
        tag = f"serve dense leg ({leg})"
        outs, stats = serve_leg(model, cfg, dev, card, prompts, spec, tag, **kw)
        stats["gate"] = check_serve_leg(tag, model, prompts, outs, stats, spread, spec["max_new"],
                                        sampling=kw.get("sampling"),
                                        allowed_cached=allowed if kw.get("prefix_cache", True)
                                        else [0] * len(prompts))
        legs[leg] = (outs, stats)
    t0 = time.perf_counter()
    greedy = [tdec.greedy_generate(model, cfg, p, max_new_tokens=spec["max_new"])[len(p):]
              for p in prompts[:SERVE_GREEDY_PROMPTS]]
    log(f"serve dense: greedy_generate of the first {len(greedy)} prompts in "
        f"{time.perf_counter() - t0:.1f} s")
    a = [o.token_ids for o in legs["a"][0]]
    pairs = {"(a)/(b)": (a, [o.token_ids for o in legs["b"][0]]),
             "(a)/(c)": (a, [o.token_ids for o in legs["c"][0]]),
             "(a)/greedy_generate": (a[:len(greedy)], greedy),
             "sampled (a)/(c)": ([o.token_ids for o in legs["d-a"][0]],
                                 [o.token_ids for o in legs["d-c"][0]])}
    log("serve dense: agreement between legs (share of requests with identical tokens; mean "
        "length of the common prefix of each pair, of " + str(spec["max_new"]) + "): "
        + "; ".join(f"{k} {match_share(x, y):.3f}, {common_prefix(x, y):.1f}"
                    for k, (x, y) in pairs.items()))
    summary = {leg: {k: v for k, v in st.items() if k not in ("cached_tokens", "launches",
                                                                "fallbacks")}
               for leg, (_, st) in legs.items()}
    log("serve dense summary: " + json.dumps(summary))
    launches = {k: sum(st["launches"][k] for _, st in legs.values())
                for k in legs["a"][1]["launches"]}
    del model, legs
    gc.collect()
    torch.cuda.empty_cache()
    return launches


SERVE_GEMMA = dict(slots=16, block=16, max_model_len=4096, requests=16, wave=8, wave_ticks=4,
                   prompt=(64, 1536), shared_prefix=512, max_new=128)


def phase_serve_gemma3(dev, card):
    """Gemma-3-1B, all 26 layers in bf16, through the engine: leg (a) of
    the dense phase (prefix cache, 512-token chunks) over prompts of
    64-2048 tokens, every other one behind a shared 512-token prefix, so
    the 512-token window of its 22 sliding layers bites."""
    from veomni_tpu_torch.models import TransformerConfig
    from veomni_tpu_torch.models import decode as tdec
    from veomni_tpu_torch.train_text_step import HF_CONFIGS, SEED

    host_state("serve gemma3")
    spec = SERVE_GEMMA
    cfg = TransformerConfig.from_hf_config(HF_CONFIGS[GEMMA_PRESET], param_dtype=torch.bfloat16)
    model = random_model(dev, cfg, SEED)
    prompts = serve_traffic(cfg.vocab_size, spec)
    allowed = shared_blocks(prompts, spec["block"])
    lens = [len(p) for p in prompts]
    windows = [cfg.window_for_layer(i) for i in range(cfg.num_hidden_layers)]
    log(f"serve gemma3: Gemma-3-1B ({cfg.num_hidden_layers} layers, {windows.count(0)} full "
        f"attention, {len(windows) - windows.count(0)} with window {max(windows)}, bf16 weights "
        f"from seed {SEED}, norm weights 0), {spec['slots']} slots, block {spec['block']}, max_model_len "
        f"{spec['max_model_len']}; {len(prompts)} requests of {min(lens)}-{max(lens)} prompt "
        f"tokens ({len(prompts) // 2} behind one {spec['shared_prefix']}-token prefix), "
        f"{spec['max_new']} new tokens each, waves of {spec['wave']} [{card}]")
    spread = first_token_spread(model, cfg, tdec._compute_cast(model, cfg), prompts,
                                "serve gemma3")
    tag = "serve gemma3 leg (a)"
    outs, stats = serve_leg(model, cfg, dev, card, prompts, spec, tag)
    check_serve_leg(tag, model, prompts, outs, stats, spread, spec["max_new"],
                    allowed_cached=allowed)
    summary = {k: v for k, v in stats.items() if k not in ("cached_tokens", "launches",
                                                           "fallbacks")}
    log("serve gemma3 summary: " + json.dumps(summary))
    launches = stats["launches"]
    del model, outs
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def capture_group_sizes(model, cfg, dev, prompts, spec):
    """Layer 0's group sizes of one prefill chunk (M = top-k x chunk rows)
    and of one decode step (M = top-k x slots) of the serving engine: the K4 shapes
    of the serving path. A short run of its own, with a recording impl
    pinned for the grouped GEMM (it calls the kernel)."""
    from veomni_tpu_torch.ops.cuda import grouped_gemm as gg
    from veomni_tpu_torch.ops.kernel_registry import KERNEL_REGISTRY, apply_ops_config
    from veomni_tpu_torch.serving import EngineConfig, InferenceEngine, Request, SamplingParams

    seen = {}

    def record(tokens, weights, group_sizes):
        seen.setdefault(tokens.shape[0], group_sizes.clone())
        return gg.cuda_group_gemm(tokens, weights, group_sizes)

    KERNEL_REGISTRY.register("group_gemm", "__serve_capture", device_types=("cuda",))(record)
    eng = InferenceEngine(model, cfg, EngineConfig(
        num_slots=spec["slots"], block_size=spec["block"], max_model_len=spec["max_model_len"],
        prefill_chunk=SERVE_CHUNK), device=dev)
    apply_ops_config({"group_gemm": "__serve_capture"})
    try:
        ids = [eng.submit(Request(prompt_ids=(p * 2)[:SERVE_CHUNK],
                                  sampling=SamplingParams(max_new_tokens=2)))
               for p in prompts[:spec["slots"]]]
        eng.step()
    finally:
        apply_ops_config(None)
        KERNEL_REGISTRY._ops["group_gemm"].pop("__serve_capture")
        KERNEL_REGISTRY._resolve.cache_clear()
    for rid in ids:
        eng.cancel(rid)
    del eng
    torch.cuda.empty_cache()
    top_k = cfg.num_experts_per_tok
    return seen[top_k * SERVE_CHUNK], seen[top_k * spec["slots"]]


QWEN3_MOE_WIDTHS = ((2048, 768, "gate/up"), (768, 2048, "down"))


def gmm_fwd_rows(dev, sizes, tag, widths=QWEN3_MOE_WIDTHS):
    """K4 alone at a serving shape, at each (K, N) of ``widths`` (Qwen3-MoE:
    (2048, 768) and (768, 2048)): held against its plain version, then its
    time, the plain version's, torch._grouped_mm's and the bound (bytes:
    lhs, the weights of the experts this routing uses, out)."""
    from veomni_tpu_torch.ops.cuda import grouped_gemm as gg

    sizes = sizes.to(dev)
    e = sizes.numel()
    starts = gg.group_starts(sizes)
    m = int(starts[-1])
    used = int((sizes > 0).sum())
    rows = []
    for k, n, what in widths:
        gen = torch.Generator(device=dev).manual_seed(3)
        lhs = torch.randn(m, k, device=dev, generator=gen).bfloat16()
        rhs = torch.randn(e, k, n, device=dev, generator=gen).bfloat16()
        ref = gg.gmm_plain(lhs, rhs, starts)
        err = check_close(f"K4 out ({tag} {what}: K={k} N={n})", gg.gmm_cuda(lhs, rhs, starts),
                          ref, atol=GMM_ATOL_MAX * ref.float().abs().max().item(), rtol=GMM_RTOL)
        lib_ms, lib_name = library_gmm("fwd", lhs, rhs, None, starts)
        bound = bound_ms(dev, 2.0 * m * k * n, (m * k + used * k * n + m * n) * 2 + (e + 1) * 4)
        row = dict(name="gmm_fwd", route="cuda", source="veomni_tpu_torch/csrc/grouped_gemm.cu",
                   replaces="veomni_tpu/ops/pallas/grouped_gemm.py:37", k=k, n=n,
                   layout=f"{tag} {what}: M={m} E={e}, {used} experts non-empty",
                   max_abs_err=err, ms=timed_ms(lambda: gg.gmm_cuda(lhs, rhs, starts), reps=50),
                   plain_ms=timed_ms(lambda: gg.gmm_plain(lhs, rhs, starts), reps=3, warmup=1),
                   bound_ms=bound[0], bound_by=bound[1], library_ms=lib_ms)
        log(f"  K4 ({tag} {what}, K={k} N={n}, M={m}, {used}/{e} experts): {row['ms']:.4f} ms "
            f"(bound {row['bound_ms']:.4f} ms by {row['bound_by']}, plain {row['plain_ms']:.3f} ms, "
            f"library {lib_ms:.4f} ms [{lib_name}])")
        rows.append(row)
        del lhs, rhs, ref
        torch.cuda.empty_cache()
    return rows


def phase_serve_moe(dev, card):
    """The serving main path at Qwen3-30B-A3B, full width and SERVE_MOE_LAYERS
    of its 48 layers (bf16 weights, no master copy): leg (a) with K4 on every MoE layer of
    every prefill chunk and decode step; then K4 alone at the serving
    shapes. Between them, the int8 tiers' quality gate and one int8 engine
    leg (kv and weights, SERVE_MOE_QUANT_REQUESTS requests). Returns
    (launches, K4 table rows, the int8 leg's launches)."""
    from veomni_tpu_torch.models import Transformer
    from veomni_tpu_torch.models import decode as tdec
    from veomni_tpu_torch.train_text_step import SEED, bench_config

    held = torch.cuda.memory_allocated(dev)
    log(f"serve moe: device memory allocated before the phase {held / 2**20:.1f} MiB")
    if held > 256 * 2**20:
        raise AssertionError(f"serve moe: {held / 2**30:.2f} GiB still allocated by earlier phases")
    host_state("serve moe")
    spec = SERVE_MOE
    cfg = bench_config(MOE_PRESET, param_dtype="bfloat16", num_hidden_layers=SERVE_MOE_LAYERS)
    t0 = time.perf_counter()
    model = Transformer(cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"serve moe: Qwen3-30B-A3B, {cfg.num_hidden_layers} of 48 layers, {n_params / 1e9:.2f} B "
        f"parameters in bf16 ({torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB) made on the "
        f"card from seed {SEED} in {time.perf_counter() - t0:.1f} s; {spec['slots']} slots, "
        f"block {spec['block']}, max_model_len {spec['max_model_len']}; {spec['requests']} "
        f"requests of {spec['prompt'][0]}-{spec['prompt'][1]} prompt tokens, "
        f"{spec['max_new']} new tokens each [{card}]")
    prompts = serve_traffic(cfg.vocab_size, spec)
    spread = first_token_spread(model, cfg, tdec._compute_cast(model, cfg), prompts, "serve moe")
    tag = "serve moe leg (a)"
    outs, stats = serve_leg(model, cfg, dev, card, prompts, spec, tag)
    passes = stats["prefill_chunks"] + stats["decode_steps"]
    want = {"gmm_fwd": 3 * cfg.num_hidden_layers * passes}
    log(f"  {tag}: K4 launches {stats['launches']['gmm_fwd']} = 3 x {cfg.num_hidden_layers} x "
        f"({stats['prefill_chunks']} prefill chunks + {stats['decode_steps']} decode steps) "
        f"expected {want['gmm_fwd']}")
    check_serve_leg(tag, model, prompts, outs, stats, spread, spec["max_new"],
                    allowed_cached=shared_blocks(prompts, spec["block"]), want_launches=want)
    launches = stats["launches"]
    # the int8 tiers on the same model: the quality gate, then one engine leg
    # with both tiers over the first requests, K4 on every MoE layer of every
    # prefill chunk and decode step (the experts stay bf16)
    quality_gate(model, cfg, "serve moe", card, floor=False)
    n_q = SERVE_MOE_QUANT_REQUESTS
    q8 = int8_legs(model, cfg, dev, card, prompts[:n_q], dict(spec, requests=n_q, wave=n_q),
                   "serve moe", [("int8", "int8")], spread=spread, want=lambda st: {
                       "gmm_fwd": 3 * cfg.num_hidden_layers * (st["prefill_chunks"]
                                                               + st["decode_steps"])})
    q8_launches = q8[("int8", "int8")]["launches"]
    prefill_sizes, decode_sizes = capture_group_sizes(model, cfg, dev, prompts, spec)
    del model, outs
    gc.collect()
    torch.cuda.empty_cache()
    rows = (gmm_fwd_rows(dev, decode_sizes, "serve decode step")
            + gmm_fwd_rows(dev, prefill_sizes, f"serve prefill chunk of {SERVE_CHUNK}"))
    return launches, rows, q8_launches


SERVE_GPT_OSS = dict(slots=8, block=16, max_model_len=4096, requests=8, wave=4, wave_ticks=4,
                     prompt=(64, 1536), shared_prefix=0, max_new=64)


def phase_serve_gpt_oss(dev, card):
    """The serving main path at gpt-oss-20b, full width and all 24 layers
    (bf16 weights from seed 0 with ``random_model``'s gpt-oss draws, the
    matrices at std GPT_OSS_SERVE_STD; no master copy): leg (a) of the MoE
    phase over 16 requests of 64-1536
    tokens, with sinks and the 128-token window in every paged attention,
    the router and expert biases and the clamped GLU in every MoE layer and
    K4 three times a layer in every pass; then K4 alone at the engine's
    decode shape. Returns (launches, K4 table rows)."""
    from veomni_tpu_torch.models import TransformerConfig
    from veomni_tpu_torch.models import decode as tdec
    from veomni_tpu_torch.train_text_step import HF_CONFIGS, SEED

    held = torch.cuda.memory_allocated(dev)
    log(f"serve gpt_oss: device memory allocated before the phase {held / 2**20:.1f} MiB")
    if held > 256 * 2**20:
        raise AssertionError(f"serve gpt_oss: {held / 2**30:.2f} GiB still allocated by earlier "
                             f"phases")
    host_state("serve gpt_oss")
    spec = SERVE_GPT_OSS
    cfg = TransformerConfig.from_hf_config(HF_CONFIGS[GPT_OSS_PRESET], param_dtype=torch.bfloat16,
                                           initializer_range=GPT_OSS_SERVE_STD)
    t0 = time.perf_counter()
    model = random_model(dev, cfg, SEED)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    kv = 2 * cfg.num_hidden_layers * cfg.num_key_value_heads * cfg.head_dim * 2
    log(f"serve gpt_oss: {GPT_OSS_NAME}, {cfg.num_hidden_layers} layers, {n_params / 1e9:.2f} B "
        f"parameters in bf16 ({torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB, "
        f"{kv // 1024} KiB of KV a token) made on the card from seed {SEED} in "
        f"{time.perf_counter() - t0:.1f} s; {spec['slots']} slots, block {spec['block']}, "
        f"max_model_len {spec['max_model_len']}; {spec['requests']} requests of "
        f"{spec['prompt'][0]}-{spec['prompt'][1]} prompt tokens, {spec['max_new']} new tokens "
        f"each [{card}]")
    prompts = serve_traffic(cfg.vocab_size, spec)
    spread = first_token_spread(model, cfg, tdec._compute_cast(model, cfg), prompts,
                                "serve gpt_oss")
    tag = "serve gpt_oss leg (a)"
    outs, stats = serve_leg(model, cfg, dev, card, prompts, spec, tag)
    passes = stats["prefill_chunks"] + stats["decode_steps"]
    want = {"gmm_fwd": 3 * cfg.num_hidden_layers * passes}
    log(f"  {tag}: K4 launches {stats['launches']['gmm_fwd']} = 3 x {cfg.num_hidden_layers} x "
        f"({stats['prefill_chunks']} prefill chunks + {stats['decode_steps']} decode steps) "
        f"expected {want['gmm_fwd']}")
    check_serve_leg(tag, model, prompts, outs, stats, spread, spec["max_new"],
                    allowed_cached=shared_blocks(prompts, spec["block"]), want_launches=want)
    launches = stats["launches"]
    _, decode_sizes = capture_group_sizes(model, cfg, dev, prompts, spec)
    del model, outs
    gc.collect()
    torch.cuda.empty_cache()
    rows = gmm_fwd_rows(dev, decode_sizes, f"{GPT_OSS_NAME} serve decode step",
                        widths=((2880, 2880, "gate/up and down"),))
    for row in rows:
        row["path_layout"] = GPT_OSS_LAYOUT
    return launches, rows


# --------------------------------------------------------------------------
# The vision-language trainer: Qwen2-VL-2B and Qwen2.5-VL-3B from HF
# directories through VLMTrainer (tasks/train_vlm.py)
# --------------------------------------------------------------------------
# Qwen/Qwen2-VL-2B-Instruct's config.json as published
QWEN2_VL_2B = {
    "architectures": ["Qwen2VLForConditionalGeneration"], "attention_dropout": 0.0,
    "bos_token_id": 151643, "eos_token_id": 151645, "vision_start_token_id": 151652,
    "vision_end_token_id": 151653, "vision_token_id": 151654, "image_token_id": 151655,
    "video_token_id": 151656, "hidden_act": "silu", "hidden_size": 1536,
    "initializer_range": 0.02, "intermediate_size": 8960, "max_position_embeddings": 32768,
    "max_window_layers": 28, "model_type": "qwen2_vl", "num_attention_heads": 12,
    "num_hidden_layers": 28, "num_key_value_heads": 2, "rms_norm_eps": 1e-06,
    "rope_theta": 1000000.0, "sliding_window": 32768, "tie_word_embeddings": True,
    "torch_dtype": "bfloat16", "transformers_version": "4.41.2", "use_cache": True,
    "use_sliding_window": False,
    "vision_config": {"depth": 32, "embed_dim": 1280, "mlp_ratio": 4, "num_heads": 16,
                      "in_chans": 3, "hidden_size": 1536, "patch_size": 14,
                      "spatial_merge_size": 2, "spatial_patch_size": 14,
                      "temporal_patch_size": 2},
    "rope_scaling": {"type": "mrope", "mrope_section": [16, 24, 24]},
    "vocab_size": 151936,
}
# Qwen/Qwen2.5-VL-3B-Instruct's config.json as published
QWEN2_5_VL_3B = {
    "architectures": ["Qwen2_5_VLForConditionalGeneration"], "attention_dropout": 0.0,
    "bos_token_id": 151643, "eos_token_id": 151645, "vision_start_token_id": 151652,
    "vision_end_token_id": 151653, "vision_token_id": 151654, "image_token_id": 151655,
    "video_token_id": 151656, "hidden_act": "silu", "hidden_size": 2048,
    "initializer_range": 0.02, "intermediate_size": 11008, "max_position_embeddings": 128000,
    "max_window_layers": 70, "model_type": "qwen2_5_vl", "num_attention_heads": 16,
    "num_hidden_layers": 36, "num_key_value_heads": 2, "rms_norm_eps": 1e-06,
    "rope_theta": 1000000.0, "sliding_window": 32768, "tie_word_embeddings": True,
    "torch_dtype": "bfloat16", "transformers_version": "4.41.2", "use_cache": True,
    "use_sliding_window": False,
    "vision_config": {"depth": 32, "hidden_act": "silu", "hidden_size": 1280,
                      "intermediate_size": 3420, "num_heads": 16, "in_chans": 3,
                      "out_hidden_size": 2048, "patch_size": 14, "spatial_merge_size": 2,
                      "spatial_patch_size": 14, "window_size": 112,
                      "fullatt_block_indexes": [7, 15, 23, 31], "tokens_per_second": 2,
                      "temporal_patch_size": 2},
    "rope_scaling": {"type": "mrope", "mrope_section": [16, 24, 24]},
    "vocab_size": 151936,
}
VLM_YAML = """
model:
  config_path: {hf}
  model_path: {hf}
data:
  train_path: {data}
  data_type: pretokenized
  max_seq_len: {seq}
  max_patches: {patches}
train:
  micro_batch_size: {micro_bs}
  train_steps: {steps}
  bf16: true
  param_dtype: float32
  enable_gradient_checkpointing: true
  gradient_checkpointing_policy: ctx
  lr: 1.0e-4
  lr_decay_style: cosine
  seed: 0
  save_hf_weights: {save_hf}
  log_steps: 1
"""
VLM_SEQ = 4096
VLM_MICRO_BS = 2
# the micro-batch's patch budget, a multiple of K1-K3's 128-row tiles; each
# row's images (at most 1408 patches) fit its share, max_patches / 2
VLM_MAX_PATCHES = 3072
# (height, width) in pixels of each corpus row's images, in turn: 448 x 448 is
# 32 x 32 patches (256 merged tokens), 336 x 672 24 x 48 (288), 224 x 224 256
# patches (64)
VLM_ROW_IMAGES = [[(448, 448), (224, 224)], [(336, 672)], [(224, 224), (336, 672)],
                  [(448, 448)]]
# block 0's q/k and text layer 0's q_proj/k_proj are redrawn at std
# VLM_QK_SPREAD / sqrt(width), so that their attention scores spread ~3: at the
# init's std 0.02 they spread ~0.3-0.6, the softmax is near uniform, and the
# checks could not see the rope's positions (as the gpt-oss phase redraws
# the weights its checks read)
VLM_QK_SPREAD = 1.7
QWEN2_VL_STEPS = 2  # cut with the remat and int8 serving phases (was 3)
QWEN2_5_VL_STEPS = 2
# of 36 (36 would be ~3.75 B parameters, ~60 GB of f32 state; at 9 the
# step-1 loss left the plain attention's by rel 1.59e-4, over its 1e-4)
QWEN2_5_VL_LAYERS = 18
QWEN2_VL_LAYERS = 14  # of 28 (all 28 until the same PR)
VLM_SPECS = {
    "qwen2_vl": dict(name="Qwen2-VL-2B", published=QWEN2_VL_2B, layers=QWEN2_VL_LAYERS,
                     steps=QWEN2_VL_STEPS, export=True),
    "qwen2_5_vl": dict(name="Qwen2.5-VL-3B", published=QWEN2_5_VL_3B, layers=QWEN2_5_VL_LAYERS,
                       steps=QWEN2_5_VL_STEPS, export=False),
}


def vlm_param_count(cfg) -> int:
    """The composite's parameter count from its config, counted here: the
    tower (patch embed, blocks, merger) and the qwen2 text model (q/k/v
    biases, tied or untied head)."""
    v, t = cfg.vision, cfg.text
    d, md = v.width, v.width * v.merge_unit
    if cfg.model_type == "qwen2_vl":
        block = 4 * d + 3 * d * d + 3 * d + d * d + d + 2 * d * v.intermediate_size \
            + v.intermediate_size + d
        merger = 2 * d + md * md + md + md * v.hidden_size + v.hidden_size
    else:
        block = 2 * d + 3 * d * d + 3 * d + d * d + d + 3 * d * v.intermediate_size \
            + 2 * v.intermediate_size + d
        merger = d + md * md + md + md * v.out_hidden_size + v.out_hidden_size
    h, kv = t.hidden_size, t.num_key_value_heads * t.head_dim
    layer = 2 * h + h * h + h + 2 * (h * kv + kv) + h * h + 3 * h * t.intermediate_size
    text = t.vocab_size * h * (1 if t.tie_word_embeddings else 2) + h + t.num_hidden_layers * layer
    return v.patch_dim * d + v.depth * block + merger + text


def vlm_rows(cfg, n_rows: int, seed: int = 0):
    """Pretokenized rows (token ids uniform over the vocabulary, filling the
    row to 3000-3600 tokens with its image placeholders) with HWC uint8
    images drawn from ``seed`` (VLM_ROW_IMAGES, in turn), passed as arrays."""
    rng = np.random.default_rng(seed)
    m2 = cfg.vision.patch_size ** 2 * cfg.vision.merge_unit
    rows = []
    for i in range(n_rows):
        sizes = VLM_ROW_IMAGES[i % len(VLM_ROW_IMAGES)]
        images = [rng.integers(0, 256, (hh, ww, 3), dtype=np.uint8) for hh, ww in sizes]
        header = sum(1 + hh * ww // m2 for hh, ww in sizes)
        n_text = int(rng.integers(3000, 3601)) - header
        rows.append({"input_ids": rng.integers(0, cfg.vocab_size, n_text).tolist(),
                     "images": images})
    return rows


def write_vlm_run(dev, tmp: str, spec, family, seed: int = 0):
    """The run's inputs under ``tmp``: the HF directory (random bf16
    weights from ``seed``, the checked q/k redrawn (VLM_QK_SPREAD) from
    ``seed + 1``, written
    by the family's HF export, then the published config.json,
    ``num_hidden_layers`` set where the depth is cut), the corpus (VLM rows as JSON lines, images as nested lists) and
    the YAML. Returns (the YAML's path, the written model, the first
    micro-batch's rows)."""
    from veomni_tpu_torch.models.auto import FoundationModel

    published = dict(spec["published"])
    if spec["layers"] is not None:
        published["num_hidden_layers"] = spec["layers"]
    cfg = family.config_from_hf(published, param_dtype=torch.bfloat16)
    hf_dir = os.path.join(tmp, "hf")
    written = FoundationModel(cfg).init(torch.Generator(device=dev).manual_seed(seed), device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    with torch.no_grad():
        qkv = written.vision_tower.blocks[0].qkv_w  # [D, 3D]: q, k, v columns
        width = qkv.shape[0]
        qkv[:, :2 * width].copy_(torch.randn(width, 2 * width, generator=gen, device=dev)
                                 * (VLM_QK_SPREAD / width ** 0.5))
        layer = written.language_model.layers[0]
        for w in (layer.q_proj, layer.k_proj):
            w.copy_(torch.randn(w.shape, generator=gen, device=dev)
                    * (VLM_QK_SPREAD / w.shape[0] ** 0.5))
    family.save_hf_checkpoint(written, hf_dir)
    with open(os.path.join(hf_dir, "config.json"), "w") as f:
        json.dump(published, f, indent=2)
    # every step's micro-batch and the prefetcher's two ahead, in one epoch
    rows = vlm_rows(cfg, VLM_MICRO_BS * (spec["steps"] + 3))
    data = os.path.join(tmp, "corpus.jsonl")
    with open(data, "w") as f:
        for row in rows:
            f.write(json.dumps({"input_ids": row["input_ids"],
                                "images": [im.tolist() for im in row["images"]]}) + "\n")
    path = os.path.join(tmp, "vlm.yaml")
    with open(path, "w") as f:
        f.write(VLM_YAML.format(hf=hf_dir, data=data, seq=VLM_SEQ, patches=VLM_MAX_PATCHES,
                                micro_bs=VLM_MICRO_BS, steps=spec["steps"],
                                save_hf=str(spec["export"]).lower()))
    return path, written, rows[:VLM_MICRO_BS]


def vlm_first_batch(cfg, rows):
    """The micro-batch the port's transform and collator make of ``rows``
    (the trainer's data path at this run's settings)."""
    from veomni_tpu_torch.data.data_transform import build_data_transform
    from veomni_tpu_torch.data.multimodal import Qwen2VLCollator, Qwen25VLCollator

    transform = build_data_transform(cfg.model_type, vlm_config=cfg, max_seq_len=VLM_SEQ,
                                     max_patches_per_sample=VLM_MAX_PATCHES // VLM_MICRO_BS)
    collator = (Qwen2VLCollator if cfg.model_type == "qwen2_vl" else Qwen25VLCollator)(
        VLM_SEQ, VLM_MICRO_BS, cfg, VLM_MAX_PATCHES)
    samples = [transform(row) for row in rows]
    return collator(samples), [g for s in samples for g in s["vis_grids"]]


def own_patch_positions(grids, m: int) -> np.ndarray:
    """[N, 2] (row, column) of each patch in HF's merge-block order, counted
    here: frame by frame, m x m blocks row by row, each block's patches row
    by row."""
    out = []
    for t, h, w in grids:
        for _ in range(t):
            for bh in range(h // m):
                for bw in range(w // m):
                    out += [(bh * m + i, bw * m + j) for i in range(m) for j in range(m)]
    return np.asarray(out, np.int64)


def own_window_order(grids, vcfg):
    """Qwen2.5-VL's window order, counted here: (the merged tokens in window
    order as indices into image order, one segment id per window and per
    frame for each merged token in that order). Windows of window_size
    pixels tile each frame's merged-token grid row by row, the last ones
    clipped."""
    m, ws = vcfg.spatial_merge_size, vcfg.window_size // vcfg.spatial_merge_size // vcfg.patch_size
    order, win_ids, base, win = [], [], 0, 0
    for t, h, w in grids:
        lh, lw = h // m, w // m
        for ti in range(t):
            for r0 in range(0, lh, ws):
                for c0 in range(0, lw, ws):
                    win += 1
                    for r in range(r0, min(r0 + ws, lh)):
                        for c in range(c0, min(c0 + ws, lw)):
                            order.append(base + (ti * lh + r) * lw + c)
                            win_ids.append(win)
        base += t * lh * lw
    return np.asarray(order, np.int64), np.asarray(win_ids, np.int64)


def own_vision_block(model_type, p, x, pos, seg, heads):
    """chip_smoke's f32 vision block: the norm (LayerNorm with bias, or
    RMSNorm), q/k/v with bias, the 2-D rope (the first half of each head's
    frequencies turned by the patch's row, the second by its column, each
    as a complex turn of the channel pair (i, i + D/2)), attention within
    a segment, proj, the norm, the MLP (quick-GELU fc1/fc2, or biased
    SwiGLU), residuals. p: the block's parameters in f32."""
    n, d = x.shape
    hd = d // heads
    F = torch.nn.functional

    def norm(t, which):
        if model_type == "qwen2_vl":
            return F.layer_norm(t, (d,), p[f"norm{which}_w"], p[f"norm{which}_b"], 1e-6)
        return t * torch.rsqrt(t.pow(2).mean(-1, keepdim=True) + 1e-6) * p[f"norm{which}"]

    qkv = (norm(x, 1) @ p["qkv_w"] + p["qkv_b"]).view(n, 3, heads, hd)
    inv = 10000.0 ** (-torch.arange(0, hd // 2, 2, device=x.device).double() / (hd // 2))
    ang = torch.cat([pos[:, :1].double() * inv, pos[:, 1:].double() * inv], -1)  # [N, hd/2]

    def turn(t):
        z = torch.complex(t[..., :hd // 2].double(), t[..., hd // 2:].double())
        z = z * torch.polar(torch.ones_like(ang), ang)[:, None]
        return torch.cat([z.real, z.imag], -1).float()

    q, k, v = turn(qkv[:, 0]), turn(qkv[:, 1]), qkv[:, 2]
    logits = torch.einsum("qhd,khd->hqk", q, k) * hd ** -0.5
    probs = logits.masked_fill(seg[None, :, None] != seg[None, None, :], -math.inf).softmax(-1)
    x = x + torch.einsum("hqk,khd->qhd", probs, v).reshape(n, d) @ p["proj_w"] + p["proj_b"]
    y = norm(x, 2)
    if model_type == "qwen2_vl":
        hmid = y @ p["fc1_w"] + p["fc1_b"]
        return x + (hmid * torch.sigmoid(1.702 * hmid)) @ p["fc2_w"] + p["fc2_b"]
    act = F.silu(y @ p["gate_w"] + p["gate_b"]) * (y @ p["up_w"] + p["up_b"])
    return x + act @ p["down_w"] + p["down_b"]


def own_merger(model_type, p, x, unit: int):
    """chip_smoke's f32 merger: the norm, each run of ``unit`` patches
    concatenated, fc1 -> GELU (erf, as HF) -> fc2."""
    F = torch.nn.functional
    d = x.shape[1]
    if model_type == "qwen2_vl":
        y = F.layer_norm(x, (d,), p["ln_q_w"], p["ln_q_b"], 1e-6)
    else:
        y = x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + 1e-6) * p["ln_q"]
    y = F.gelu(y.reshape(-1, unit * d) @ p["fc1_w"] + p["fc1_b"])
    return y @ p["fc2_w"] + p["fc2_b"]


def own_text_layer(cfg, p, hidden, pos3, seg):
    """chip_smoke's f32 qwen2 decoder layer on one row: RMSNorm, q/k/v with
    bias, mrope (frequency j of head dim D turned by the position stream its
    ``mrope_section`` names: the first 16 of 64 by the temporal positions,
    the next 24 by the rows, the last 24 by the columns, pairs (j, j + D/2)),
    causal attention within a segment (GQA), o_proj, RMSNorm, SwiGLU,
    residuals. pos3 [3, S]."""
    s, h = hidden.shape
    nh, nkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim

    def rms(t, w):
        return t * torch.rsqrt(t.pow(2).mean(-1, keepdim=True) + cfg.rms_norm_eps) * w

    x = rms(hidden, p["input_layernorm"])
    q = (x @ p["q_proj"] + p["q_bias"]).view(s, nh, hd)
    k = (x @ p["k_proj"] + p["k_bias"]).view(s, nkv, hd)
    v = (x @ p["v_proj"] + p["v_bias"]).view(s, nkv, hd)
    inv = cfg.rope_theta ** (-torch.arange(0, hd, 2, device=x.device).double() / hd)
    stream = torch.cat([torch.full((n,), i % 3, device=x.device)
                        for i, n in enumerate(cfg.rope_scaling["mrope_section"])])
    ang = pos3.double()[stream, :].t() * inv  # [S, D/2]

    def turn(t):
        z = torch.complex(t[..., :hd // 2].double(), t[..., hd // 2:].double())
        z = z * torch.polar(torch.ones_like(ang), ang)[:, None]
        return torch.cat([z.real, z.imag], -1).float()

    q, k = turn(q), turn(k).repeat_interleave(nh // nkv, 1)
    v = v.repeat_interleave(nh // nkv, 1)
    logits = torch.einsum("qhd,khd->hqk", q, k) * hd ** -0.5
    idx = torch.arange(s, device=x.device)
    visible = (idx[:, None] >= idx[None]) & (seg[:, None] == seg[None])
    probs = logits.masked_fill(~visible, -math.inf).softmax(-1)
    hidden = hidden + torch.einsum("hqk,khd->qhd", probs, v).reshape(s, nh * hd) @ p["o_proj"]
    y = rms(hidden, p["post_attention_layernorm"])
    act = torch.nn.functional.silu(y @ p["gate_proj"]) * (y @ p["up_proj"])
    return hidden + act @ p["down_proj"]


def phase_vlm_checks(dev, card, tag, hf_dir, model, batch, grids):
    """The model as loaded against chip_smoke's own f32 pieces, token by
    token, on the first micro-batch: the patch embed (HF's Conv3d weight
    read from the directory, contracted with each processor-flattened
    (C, T, Ph, Pw) patch), vision block 0 (its positions and segments
    counted here), the merger and the order it leaves in (Qwen2.5-VL's
    window order undone as counted here), and text layer 0 under mrope."""
    from veomni_tpu_torch.models import hf_io
    from veomni_tpu_torch.models.qwen2_5_vl import merge_vision_features

    cfg, vcfg = model.cfg, model.cfg.vision
    dt = cfg.text.dtype
    mt, unit = cfg.model_type, vcfg.merge_unit
    tower = model.vision_tower
    t = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    n_real = sum(a * b * c for a, b, c in grids)
    m_real = n_real // unit
    pos_own = own_patch_positions(grids, vcfg.spatial_merge_size)
    if mt == "qwen2_5_vl":
        order, win = own_window_order(grids, vcfg)
        patch_order = (order[:, None] * unit + np.arange(unit)).reshape(-1)
        pos_own = pos_own[patch_order]
        seg_own = np.repeat(win, unit)
        seg_key = "vis_seg_window"
    else:
        order = np.arange(m_real)
        frame_lens = [h * w for tt, h, w in grids for _ in range(tt)]
        seg_own = np.repeat(np.arange(1, len(frame_lens) + 1), frame_lens)
        seg_key = "vis_seg"
    n_pad = batch["pixel_values"].shape[0]
    seg_full_own = torch.zeros(n_pad, dtype=torch.int64, device=dev)
    seg_full_own[:n_real] = torch.from_numpy(seg_own).to(dev)
    pos_t = torch.zeros(n_pad, 2, dtype=torch.int64, device=dev)
    pos_t[:n_real] = torch.from_numpy(pos_own).to(dev)
    log(f"{tag} checks: the first micro-batch's {len(grids)} images, {n_real} patches of "
        f"{n_pad} ({m_real} merged tokens), against chip_smoke's own f32 pieces [{card}]")
    with torch.no_grad():
        # the patch embed against HF's Conv3d weight, read from the directory
        w3d = hf_io.LazyHFTensors(hf_dir).read("model.visual.patch_embed.proj.weight")
        w3d = w3d.to(dev, dt).float()
        patches = t["pixel_values"][:n_real].to(dt).float()
        ref = torch.einsum("nctij,dctij->nd",
                           patches.view(n_real, vcfg.in_channels, vcfg.temporal_patch_size,
                                        vcfg.patch_size, vcfg.patch_size), w3d)
        x0 = t["pixel_values"].to(dt) @ tower.patch_embed.to(dt)
        token_check(f"{tag} check: patch embed", x0[:n_real], ref)
        # vision block 0 (Qwen2.5-VL: a windowed block)
        from veomni_tpu_torch.models.qwen2_5_vl import vision_rope

        cos, sin = vision_rope(t["vis_pos_hw"], vcfg.head_dim)
        block = tower.blocks[0]
        got = block(x0, cos, sin, t[seg_key][None])
        p = {n: w.detach().to(dt).float() for n, w in block.named_parameters()}
        ref = own_vision_block(mt, p, x0.float(), pos_t, seg_full_own, vcfg.num_heads)
        token_check(f"{tag} check: vision block 0", got[:n_real], ref[:n_real])
        del ref, got
        # the whole tower, the merger's input captured, and its output order
        cap = {}
        hook = tower.merger.register_forward_hook(lambda mod, inp, out: cap.update(x=inp[0]))
        segs, reverse = model.tower_inputs(t)
        feats = tower(t["pixel_values"], t["vis_pos_hw"], segs, reverse)
        hook.remove()
        p = {n: w.detach().to(dt).float() for n, w in tower.merger.named_parameters()}
        merged = own_merger(mt, p, cap["x"].float(), unit)[:m_real]
        ref = torch.empty_like(merged)
        ref[torch.from_numpy(order).to(dev)] = merged  # window order -> image order
        token_check(f"{tag} check: merger, image order", feats[:m_real], ref)
        # text layer 0 under mrope, row 0, on the merged embeddings
        lm = model.language_model
        embeds = merge_vision_features(lm.embed(t["input_ids"]), t["input_ids"], feats,
                                       t["vis_merged_mask"].bool(), cfg.image_token_id,
                                       cfg.video_token_id)
        cos_t, sin_t = lm.rotary(t["position_ids"])[False]
        layer = lm.layers[0]
        out, _ = layer(embeds, cos_t, sin_t, t["segment_ids"])
        p = {n: w.detach().to(dt).float() for n, w in layer.named_parameters()}
        ref = own_text_layer(cfg.text, p, embeds[0].float(), t["position_ids"][0],
                             t["segment_ids"][0])
        token_check(f"{tag} check: text layer 0 (mrope), row 0", out[0], ref)
        del ref, out, embeds, feats, cap, merged


def phase_hf_vlm(dev, card, model_type: str):
    """One vision-language model at its published widths through
    ``VLMTrainer`` from an HF directory: K1-K3 at D 80 on the first
    micro-batch's tower segments, the loaded parameters against the
    written ones and the config's count, ``phase_vlm_checks``, then
    ``steps`` steps at seq 4096 x micro-batch 2 (f32 master, bf16 compute,
    ctx remat, AdamW), launches by head dim as reckoned (the tower's blocks
    at D 80, the text layers at D 128, once per micro-batch each, no plain
    dispatch), the HF export (where on) read back bit-equal, and step 1's
    loss and grad norm against the plain attention's. Returns ({path:
    (launches, head dim, layout)}, the D-80 kernel rows)."""
    from veomni_tpu_torch.arguments import VeOmniArguments, parse_args
    from veomni_tpu_torch.models.auto import VLM_FAMILIES, build_foundation_model
    from veomni_tpu_torch.ops.cuda import flash_attention as fa
    from veomni_tpu_torch.ops.kernel_registry import apply_ops_config
    from veomni_tpu_torch.optim import build_lr_scheduler, build_optimizer
    from veomni_tpu_torch.parallel.parallel_state import destroy_parallel_state
    from veomni_tpu_torch.train import build_train_state, build_train_step
    from veomni_tpu_torch.trainer import VLMTrainer
    from veomni_tpu_torch.trainer.callbacks import Callback, CheckpointCallback
    from veomni_tpu_torch.utils.count_flops import FlopsCounter, vit_flops_fwd
    from veomni_tpu_torch.utils.device import get_device_peak_flops

    spec, family = VLM_SPECS[model_type], VLM_FAMILIES[model_type]
    name, steps = spec["name"], spec["steps"]
    tag = f"hf vlm {name}"

    class Record(Callback):
        def __init__(self):
            self.steps, self.first_batch = {}, None

        def on_step_begin(self, trainer, state):
            if self.first_batch is None:
                self.first_batch = {k: v.copy() for k, v in trainer.current_batch.items()}

        def on_step_end(self, trainer, state):
            m = state.metrics
            self.steps[state.global_step] = dict(loss=float(m["loss"]),
                                                 grad_norm=float(m["grad_norm"]),
                                                 t=time.perf_counter())

    tmp = tempfile.mkdtemp(prefix=f"chip_smoke_{model_type}_")
    try:
        t0 = time.perf_counter()
        yaml_path, written, first_rows = write_vlm_run(dev, tmp, spec, family)
        write_s = time.perf_counter() - t0
        hf_dir = os.path.join(tmp, "hf")
        cfg = written.cfg
        batch, grids = vlm_first_batch(cfg, first_rows)
        # K1-K3 at D 80 on the tower's segments of this micro-batch
        vseg = batch["vis_seg"] if model_type == "qwen2_vl" else batch["vis_seg_window"]
        seg = torch.from_numpy(vseg)[None].to(dev)
        heads = cfg.vision.num_heads
        what = "per-frame" if model_type == "qwen2_vl" else "per-window"
        rows = phase_flash(dev, seg, heads, heads, f"{name} tower, {what} segments",
                           d=cfg.vision.head_dim, causal=False)
        for row in rows:
            row["path_layout"] = model_type
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        fm = build_foundation_model(hf_dir, weights_path=hf_dir, device=dev)
        load_s = time.perf_counter() - t0
        model = fm.module
        n_params = sum(w.numel() for w in model.parameters())
        want_params = vlm_param_count(fm.config)
        v, tc = fm.config.vision, fm.config.text
        cut = f" (of {spec['published']['num_hidden_layers']})" if spec["layers"] else ""
        log(f"{tag}: tower depth {v.depth}, width {v.width}, {v.num_heads} heads of "
            f"{v.head_dim}; text {tc.num_hidden_layers} layers{cut}, hidden {tc.hidden_size}, heads {tc.num_attention_heads}/"
            f"{tc.num_key_value_heads} of {tc.head_dim}, vocab {tc.vocab_size}, mrope "
            f"{tc.rope_scaling['mrope_section']}; {n_params} parameters (counted from the "
            f"config: {want_params}); HF directory, corpus and YAML written in {write_s:.1f} s, "
            f"loaded in {load_s:.1f} s [{card}]")
        bad = [n for (n, x), (_, y) in zip(model.named_parameters(), written.named_parameters())
               if not torch.equal(x, y.to(x.dtype))]
        log(f"{tag}: the loaded parameters against the written ones: "
            + ("bit-equal" if not bad else f"{len(bad)} differ, e.g. {bad[:3]} FAILED"))
        if bad or n_params != want_params:
            raise AssertionError(f"{tag}: loaded parameters differ from the written ones "
                                 f"({bad[:3]}) or the count {n_params} != {want_params}")
        del written
        torch.cuda.empty_cache()
        phase_vlm_checks(dev, card, tag, hf_dir, model, batch, grids)
        del fm, model
        gc.collect()
        torch.cuda.empty_cache()

        args = parse_args(VeOmniArguments, [yaml_path, f"--train.output_dir={tmp}/out"])
        torch.cuda.reset_peak_memory_stats(dev)
        reset_all_counts()
        trainer = VLMTrainer(args)
        trainer.callbacks = [cb for cb in trainer.callbacks
                             if not isinstance(cb, CheckpointCallback)]
        rec = Record()
        trainer.callbacks.append(rec)
        trainer.train()
        trainer.checkpointer.close()
        launches, fallbacks = read_counts()
        by_dim = {d: dict(c) for d, c in fa.LAUNCHES_BY_HEAD_DIM.items()}
        peak = torch.cuda.max_memory_allocated(dev)
        first = rec.first_batch
        a = rec.steps
        check_steps([dict(loss=r["loss"], grad_norm=r["grad_norm"], step_ok=True)
                     for r in a.values()], tag)
        micro = first["input_ids"].shape[0]  # micro-batches a step
        lm_layers, depth = cfg.text.num_hidden_layers, cfg.vision.depth
        want = {80: micro * depth * steps, 128: micro * lm_layers * steps}
        per_kernel = {k: want[80] + want[128] for k in fa.LAUNCHES}
        bad = {k: n for k, n in launches.items() if n != per_kernel.get(k, 0)}
        bad_dim = {d: c for d, c in by_dim.items()
                   if any(n != want.get(d, 0) for n in c.values())}
        log(f"{tag}: launches {launches}, by head dim {by_dim} (expected at D 80 {want[80]} = "
            f"{micro} micro-batch x {depth} tower blocks x {steps} steps, at D 128 {want[128]} = "
            f"{micro} x {lm_layers} text layers x {steps}); FALLBACK_CALLS {fallbacks}")
        if bad or bad_dim or fallbacks["flash"]:
            raise AssertionError(f"{tag}: launches {launches} / by head dim {by_dim} differ from "
                                 f"the reckoned counts, or FALLBACK_CALLS {fallbacks} is not 0")
        tokens = int((first["labels"] != -100).sum())
        patches = int(first["vis_merged_mask"].sum()) * cfg.vision.merge_unit
        window = getattr(cfg.vision, "window_size", 0)
        tower_flops = vit_flops_fwd(cfg.vision, patches, (window // cfg.vision.patch_size) ** 2
                                    if window else None)
        flops = (FlopsCounter.from_config(cfg).batch_flops(micro * VLM_MICRO_BS * VLM_SEQ,
                                                            VLM_SEQ) + 3 * micro * tower_flops)
        peak_flops = get_device_peak_flops(dev)
        ms = [(a[i]["t"] - a[i - 1]["t"]) * 1e3 for i in range(2, steps + 1)]
        for i in range(1, steps + 1):
            extra = (f" step_ms={ms[i - 2]:.1f} mfu={flops / (ms[i - 2] / 1e3) / peak_flops:.4f}"
                     if i >= 2 else " (first step: warm-up, not timed)")
            log(f"{tag} step {i}: loss={a[i]['loss']:.6f} grad_norm={a[i]['grad_norm']:.6f}"
                f"{extra} [{card}]")
        med = sorted(ms)[len(ms) // 2]
        tok_all = micro * VLM_MICRO_BS * VLM_SEQ
        log(f"{tag}: warm steps 2-{steps} {', '.join(f'{x:.1f}' for x in ms)} ms, median "
            f"{med:.1f} ms, {tok_all / med * 1e3:.1f} tokens/s (padded rows; {tokens} supervised "
            f"tokens in the first micro-batch), {patches} patches a micro-batch of "
            f"{VLM_MAX_PATCHES}; MFU {flops / (med / 1e3) / peak_flops:.4f} (text as the "
            f"reference's FlopsCounter counts it, plus the tower's vit_flops_fwd); peak device "
            f"memory {peak / 2**30:.2f} GiB [{card}]")
        if spec["export"]:
            out = os.path.join(tmp, "out", "hf_ckpt")
            back = build_foundation_model(out, weights_path=out, device=dev)
            final = trainer.train_state.model
            bad = [n for (n, x), (_, y) in zip(back.module.named_parameters(),
                                               final.named_parameters()) if not torch.equal(x, y)]
            nbytes = sum(os.path.getsize(os.path.join(out, f)) for f in os.listdir(out))
            log(f"{tag}: the HF export ({nbytes / 1e9:.3f} GB) against the final parameters: "
                + ("bit-equal" if not bad else f"{len(bad)} differ, e.g. {bad[:3]} FAILED"))
            if bad:
                raise AssertionError(f"{tag}: the HF export differs from the final parameters")
            del back, final
        else:
            log(f"{tag}: HF export off (its f32 write and read-back would add ~30 s; the "
                f"Qwen2-VL-2B leg reads its export back)")
        del trainer
        destroy_parallel_state()
        gc.collect()
        torch.cuda.empty_cache()

        # step-1 parity: the same weights and batch with the plain attention
        # pinned (the text layers through its blockwise form at S 4096, the
        # tower's at S 3072)
        fm = build_foundation_model(hf_dir, weights_path=hf_dir, device=dev,
                                    ops_implementation={"attention": "xla"}, remat_policy="ctx")
        model = fm.module
        state = build_train_state(model, build_optimizer(
            model, lr=build_lr_scheduler(lr=1e-4, train_steps=steps)))
        tb = {k: torch.from_numpy(v).to(dev) for k, v in first.items()}
        reset_all_counts()
        try:
            _, m = build_train_step(fm.loss_fn)(state, tb)
        finally:
            apply_ops_config(None)
        plain_launches, _ = read_counts()
        loss_rel = abs(a[1]["loss"] - float(m["loss"])) / abs(float(m["loss"]))
        gn_rel = abs(a[1]["grad_norm"] - float(m["grad_norm"])) / abs(float(m["grad_norm"]))
        log(f"{tag} step-1 parity: trainer (kernels) loss {a[1]['loss']:.6f} grad norm "
            f"{a[1]['grad_norm']:.6f}, plain attention {float(m['loss']):.6f} / "
            f"{float(m['grad_norm']):.6f} (rel {loss_rel:.2e} / {gn_rel:.2e}, tol "
            f"{TOL_LOSS_REL} / {TOL_GRAD_NORM_REL}; the plain leg launched {plain_launches})")
        if (not loss_rel <= TOL_LOSS_REL or not gn_rel <= TOL_GRAD_NORM_REL
                or any(plain_launches.values())):
            raise AssertionError(f"{tag}: step 1 departs from the plain attention's or the "
                                 f"plain leg launched kernels")
        del fm, model, state, tb, m
        gc.collect()
        torch.cuda.empty_cache()
        paths = {f"hf_trainer_{model_type}": (by_dim[80], 80, model_type)}
        return paths, rows
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_hf_trainer_qwen2_vl(dev, card):
    """Qwen2-VL-2B at its published config.json, full depth, 3 steps, HF
    export (phase 18 of the module docstring)."""
    return phase_hf_vlm(dev, card, "qwen2_vl")


def phase_hf_trainer_qwen2_5_vl(dev, card):
    """Qwen2.5-VL-3B at its published widths, the text model cut to 18 of 36
    layers, 2 steps, no export (phase 19)."""
    return phase_hf_vlm(dev, card, "qwen2_5_vl")


# the VLM step-1 parity's second witness (``--phases vlm_witness``, not in
# the whole run): (model, text depth) and weight seeds
VLM_WITNESS_RUNS = (("qwen2_5_vl", 9), ("qwen2_5_vl", 18), ("qwen2_vl", 14))
VLM_WITNESS_SEEDS = (0, 1)


def phase_vlm_witness(dev, card):
    """Where the VLM step-1 parity's departure comes from. For each model
    and text depth of VLM_WITNESS_RUNS and each weight seed, the phase's
    inputs are written as ``phase_hf_vlm`` writes them and one train step
    on the first micro-batch runs four ways: K1-K3 everywhere, the plain
    attention everywhere, the tower on the plain attention with the text
    layers on K1-K3 (``tower plain``), and the reverse (``text plain``).
    Each loss and grad norm is printed against the plain one's, beside the
    parity's limits, with each way's launches. It checks nothing: it is the
    measurement, not a gate."""
    from veomni_tpu_torch.data.data_collator import stack_micro_batches
    from veomni_tpu_torch.models.auto import VLM_FAMILIES, build_foundation_model
    from veomni_tpu_torch.ops.kernel_registry import KERNEL_REGISTRY, apply_ops_config
    from veomni_tpu_torch.optim import build_lr_scheduler, build_optimizer
    from veomni_tpu_torch.train import build_train_state, build_train_step

    impls = KERNEL_REGISTRY.impls("attention")

    def by_head_dim(plain_d):
        def attend(q, k, v, **kw):
            return impls["xla" if q.shape[-1] == plain_d else "cuda_flash"].fn(q, k, v, **kw)
        return attend

    for name, plain_d in (("witness_tower_plain", 80), ("witness_text_plain", 128)):
        KERNEL_REGISTRY.register("attention", name, device_types=("cuda",))(by_head_dim(plain_d))
    ways = (("kernels", None), ("plain", "xla"), ("tower plain", "witness_tower_plain"),
            ("text plain", "witness_text_plain"))
    for model_type, depth in VLM_WITNESS_RUNS:
        spec = dict(VLM_SPECS[model_type], layers=depth)
        for seed in VLM_WITNESS_SEEDS:
            tmp = tempfile.mkdtemp(prefix=f"chip_smoke_witness_{model_type}_")
            try:
                _, written, first_rows = write_vlm_run(dev, tmp, spec, VLM_FAMILIES[model_type],
                                                       seed=seed)
                cfg = written.cfg
                del written
                torch.cuda.empty_cache()
                batch, _ = vlm_first_batch(cfg, first_rows)
                tb = {k: torch.from_numpy(v).to(dev)
                      for k, v in stack_micro_batches([batch]).items()}
                hf_dir = os.path.join(tmp, "hf")
                got = {}
                for way, pin in ways:
                    fm = build_foundation_model(
                        hf_dir, weights_path=hf_dir, device=dev, remat_policy="ctx",
                        ops_implementation={"attention": pin} if pin else None)
                    state = build_train_state(fm.module, build_optimizer(
                        fm.module, lr=build_lr_scheduler(lr=1e-4, train_steps=2)))
                    reset_all_counts()
                    try:
                        _, m = build_train_step(fm.loss_fn)(state, tb)
                    finally:
                        apply_ops_config(None)
                    launches, _ = read_counts()
                    got[way] = (float(m["loss"]), float(m["grad_norm"]), launches["flash_fwd"])
                    del fm, state, m
                    gc.collect()
                    torch.cuda.empty_cache()
                ref_loss, ref_gn, _ = got["plain"]
                log(f"vlm witness {spec['name']} text depth {depth}, weight seed {seed}: "
                    + "; ".join(f"{way} loss {l:.6f} grad norm {g:.6f} (rel {abs(l - ref_loss) / abs(ref_loss):.2e} / "
                                f"{abs(g - ref_gn) / abs(ref_gn):.2e}; K1 launches {n})"
                                for way, (l, g, n) in got.items())
                    + f" (limits {TOL_LOSS_REL} / {TOL_GRAD_NORM_REL}) [{card}]")
            finally:
                shutil.rmtree(tmp, ignore_errors=True)


REMAT_POLICIES = ("nothing", "ctx", "dots", "offload", "ctx_offload")
REMAT_STEPS = 2
REMAT_CHUNK = 1024


def remat_launches(policy: str, layers: int, steps: int):
    """K1-K3 of ``steps`` dense steps (one micro-batch each) under a remat
    policy: K2 and K3 once a layer and step; K1 once, twice under
    ``nothing``, whose backward reruns the whole layer, the attention
    forward included. The hand kernels launch through ctypes, below the
    dispatcher, so no selective-checkpoint policy caches their outputs: a
    policy saves or recomputes what surrounds them, never K1 itself. K4-K6:
    0 (the model is dense)."""
    fwd = layers * steps * (2 if policy == "nothing" else 1)
    return {"flash_fwd": fwd, "flash_bwd_dkv": layers * steps, "flash_bwd_dq": layers * steps}


def log_checks(tag, checks):
    """Log each (name, ok, what) check, then raise naming every failed one."""
    for name, ok, what in checks:
        log(f"  {tag}: {name}: {'ok' if ok else 'FAILED'}: {what}")
    failed = [f"{name} ({what})" for name, ok, what in checks if not ok]
    if failed:
        raise AssertionError(f"{tag}: " + "; ".join(failed))


def phase_remat(dev, card):
    """The bare loop at Qwen3-0.6B (full width and depth, seq 4096 x
    micro-batch 4, f32 master, bf16 compute) for REMAT_STEPS steps under
    each remat policy and under ``ctx`` with ``chunk_mbs`` REMAT_CHUNK: the
    launch counts as reckoned, step 1's loss bit-equal across the policies,
    the grad norm against ``ctx``'s, the offload policies' device peaks
    below their twins'. Returns the launches summed over the legs."""
    from veomni_tpu_torch.train_text_step import run_train_steps

    legs, total = {}, {}
    for policy, chunk in [(p, 0) for p in REMAT_POLICIES] + [("ctx", REMAT_CHUNK)]:
        tag = f"remat {policy}" + (f" + chunk_mbs {chunk}" if chunk else "")
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_all_counts()
        records = run_train_steps(4096, 4, REMAT_STEPS, device=dev,
                                  cfg_overrides={"remat_policy": policy, "chunk_mbs": chunk})
        launches, fallbacks = read_counts()
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        check_steps(records, tag)
        log(f"{tag}: step 1 loss {records[0]['loss']!r} grad_norm {records[0]['grad_norm']!r}; "
            f"step ms {', '.join(f'{r['step_ms']:.1f}' for r in records)}; peak {peak:.2f} GiB; "
            f"launches {launches} (Qwen3-0.6B, {LAYERS} layers, seq 4096, micro-batch 4) "
            f"[{card}]")
        check_counts(launches, fallbacks, remat_launches(policy, LAYERS, REMAT_STEPS), tag)
        legs[(policy, chunk)] = (records, peak)
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
    ctx, ctx_peak = legs[("ctx", 0)]
    checks = []
    for (policy, chunk), (records, peak) in legs.items():
        loss, norm = records[0]["loss"], records[0]["grad_norm"]
        loss_rel = abs(loss - ctx[0]["loss"]) / abs(ctx[0]["loss"])
        norm_rel = abs(norm - ctx[0]["grad_norm"]) / ctx[0]["grad_norm"]
        what = (f"loss {loss!r} vs ctx's {ctx[0]['loss']!r} (rel {loss_rel:.2e}); grad norm "
                f"{norm!r} vs {ctx[0]['grad_norm']!r} (rel {norm_rel:.2e}, "
                f"{'bit-equal' if norm_rel == 0 else f'limit {TOL_GRAD_NORM_REL:g}'})")
        if chunk:
            checks.append((f"chunk_mbs {chunk} step 1", loss_rel <= TOL_LOSS_REL
                           and norm_rel <= TOL_GRAD_NORM_REL, what))
        elif policy != "ctx":
            checks.append((f"{policy} step 1", loss == ctx[0]["loss"]
                           and norm_rel <= TOL_GRAD_NORM_REL, what))
    for off, twin in (("offload", "dots"), ("ctx_offload", "ctx")):
        a, b = legs[(off, 0)][1], legs[(twin, 0)][1]
        checks.append((f"{off} peak", a < b, f"{a:.2f} GiB against {twin}'s {b:.2f} GiB"))
    log_checks("remat", checks)
    return total, optimizer_legs(dev, card, ctx[0]["loss"])


# Muon's update on the card against this script's own float64 Newton-Schulz
# of the same momentum and gradient, element by element:
#   |delta - ref| <= MUON_TOL * max|ref| + 2^-23 * |p|,
# where delta is the parameter's change over the step and ref = -lr *
# NS64(0.95 buf + g) * max(1, m/n)**0.5. f32 products of K up to 3072 carry
# ~1e-6 relative error into each of the 5 iterations: 1% of the largest
# entry holds them with room. The parameter rounds its new value to f32,
# half an ulp of |p| (a norm weight at 1.0: 6e-8, the size of 1% of its
# ~1e-5 update), so one ulp of |p| is allowed on top. A skipped
# orthogonalisation moves the parameter by lr * (0.95 buf + g), a different
# shape and scale (the gradient's, not ~1/sqrt(n)), many times the limit.
MUON_TOL = 1e-2
# (reference leaf path, layer or None for a leaf stacked over the layers and
# orthogonalised jointly)
MUON_CHECKED = (("layers.q_proj", 5), ("layers.down_proj", 20), ("layers.o_proj", 27),
                ("layers.input_layernorm", None))
OTHER_OPTIMIZERS = ("anyprecision_adamw", "adafactor", "sgd")


def ns64(x):
    """The quintic Newton-Schulz of ``optim/muon.py`` in float64, written
    out here."""
    a, b, c = 3.4445, -4.7750, 2.0315
    x = x.double()
    t = x.shape[-2] > x.shape[-1]
    if t:
        x = x.mT
    x = x / (torch.linalg.matrix_norm(x) + 1e-7)
    for _ in range(5):
        xxt = x @ x.mT
        x = a * x + (b * xxt + c * (xxt @ xxt)) @ x
    return x.mT if t else x


def optimizer_legs(dev, card, ctx_loss):
    """The bare loop at Qwen3-0.6B (``ctx``) under Muon for 2 steps and one
    step under each other optimizer of ``build_optimizer``: step 1's loss
    equal to the AdamW ``ctx`` leg's (the same forward), K1-K3 28 times a
    step, and step 2's Muon update on the MUON_CHECKED leaves against
    ``ns64``. Returns the launches of the legs."""
    from veomni_tpu_torch.models.jax_weights import reference_leaves
    from veomni_tpu_torch.train_text_step import iter_train_steps, run_train_steps

    overrides = {"remat_policy": "ctx", "chunk_mbs": 0}
    total, checks = {}, []

    def add(launches):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    gc.collect()
    torch.cuda.empty_cache()
    reset_all_counts()
    keep = {}
    it = iter_train_steps(4096, 4, device=dev, optimizer="muon", keep=keep,
                          cfg_overrides=overrides)
    try:
        r1 = next(it)
        model, opt = keep["model"], keep["optimizer"]
        leaves = {path: (params, stacked) for path, params, stacked in reference_leaves(model)}
        picked = {}
        for path, layer in MUON_CHECKED:
            params, stacked = leaves[path]
            ps = params if layer is None else [params[layer]]
            picked[(path, layer)] = (ps, [p.detach().clone() for p in ps],
                                     [opt.state[p]["momentum_buffer"].clone() for p in ps])
        lr = opt.lr_schedule(1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r2 = next(it)
        torch.cuda.synchronize()
        step2_s = time.perf_counter() - t0
        for (path, layer), (ps, before, _) in picked.items():
            bufs = [opt.state[p]["momentum_buffer"] for p in ps]
            eff = torch.stack([0.95 * b.double() + p.grad.double() for b, p in zip(bufs, ps)])
            if layer is not None:
                eff = eff[0]
            m, n = eff.shape[-2], eff.shape[-1]
            ref = -lr * ns64(eff) * max(1.0, m / n) ** 0.5
            delta = torch.stack([p.detach().double() - b.double() for p, b in zip(ps, before)])
            p0 = torch.stack([b.double() for b in before])
            if layer is not None:
                delta, p0 = delta[0], p0[0]
            scale = ref.abs().max().item()
            allowed = MUON_TOL * scale + 2.0 ** -23 * p0.abs()
            worst = ((delta - ref).abs() / allowed).max().item()
            what = (f"{path}{'' if layer is None else f'[{layer}]'} {tuple(eff.shape)}: "
                    f"max |delta - ref| {(delta - ref).abs().max().item():.3e}, max |ref| "
                    f"{scale:.3e}; worst |delta - ref| / allowed {worst:.4f}")
            checks.append((f"muon update {path}{'' if layer is None else f' layer {layer}'}",
                           worst <= 1.0, what))
    finally:
        it.close()
    launches, fallbacks = read_counts()
    add(launches)
    check_steps([r1, r2], "muon")
    check_counts(launches, fallbacks, remat_launches("ctx", LAYERS, 2), "muon")
    log(f"optimizer muon: step 1 loss {r1['loss']!r} grad_norm {r1['grad_norm']!r}; step ms "
        f"{r1['step_ms']:.1f}, {r2['step_ms']:.1f} (step 2 {step2_s * 1e3:.1f} ms with the "
        f"optimizer; Newton-Schulz on every matrix leaf, 5 f32 iterations); launches "
        f"{launches} [{card}]")
    checks.append(("muon step 1 loss", r1["loss"] == ctx_loss,
                   f"{r1['loss']!r} against AdamW ctx's {ctx_loss!r} (the same forward)"))
    del keep, model, opt
    for name in OTHER_OPTIMIZERS:
        gc.collect()
        torch.cuda.empty_cache()
        reset_all_counts()
        rec = run_train_steps(4096, 4, 1, device=dev, optimizer=name, cfg_overrides=overrides)
        launches, fallbacks = read_counts()
        add(launches)
        check_steps(rec, name)
        check_counts(launches, fallbacks, remat_launches("ctx", LAYERS, 1), name)
        log(f"optimizer {name}: step 1 loss {rec[0]['loss']!r} grad_norm "
            f"{rec[0]['grad_norm']!r} step ms {rec[0]['step_ms']:.1f}; launches {launches} "
            f"[{card}]")
        checks.append((f"{name} step 1 loss", rec[0]["loss"] == ctx_loss,
                       f"{rec[0]['loss']!r} against AdamW ctx's {ctx_loss!r}"))
    log_checks("optimizers", checks)
    return total


SERVE_QUANT_MODES = (("int8", "none"), ("none", "int8"), ("int8", "int8"))
SERVE_QUANT = SERVE_DENSE
SERVE_MOE_QUANT_REQUESTS = 8
# the qwen3, gpt_oss-like and qwen3_moe toys the gate's bounds were pinned on
# (tests/tools/quality_gate.py:10-18), random weights from seed 0
GATE_TOYS = {
    "qwen3": dict(model_type="qwen3", vocab_size=128, hidden_size=64, intermediate_size=128,
                  num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                  head_dim=16, qk_norm=True),
    "gpt_oss_ish": dict(model_type="gpt_oss", vocab_size=128, hidden_size=64,
                        intermediate_size=128, num_hidden_layers=4, num_attention_heads=4,
                        num_key_value_heads=2, head_dim=16, attention_sinks=True,
                        attention_bias=True, o_bias=True, sliding_window=8,
                        layer_types=["sliding_attention", "full_attention"] * 2,
                        hidden_act="gpt_oss_glu"),
    "qwen3_moe": dict(model_type="qwen3_moe", vocab_size=128, hidden_size=64,
                      intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
                      num_key_value_heads=2, head_dim=16, qk_norm=True, num_experts=4,
                      num_experts_per_tok=2, moe_intermediate_size=32),
}
# the dense noise floor of the gate, set by phase_serve_quant: whether the
# bounds can judge a random model at full width (None: not measured)
GATE_FLOOR_OK = {}


def pair_stats(ref_rows, got_rows, corpus):
    """The gate's statistics between two teacher-forced scorings of the
    same corpus (lists of [T, V] logits), as ``quality_stats`` aggregates
    them."""
    from veomni_tpu_torch.serving import quality

    nll_ref = [np.log(quality._ppl(r, t)) for r, t in zip(ref_rows, corpus)]
    nll_got = [np.log(quality._ppl(g, t)) for g, t in zip(got_rows, corpus)]
    ppl_ref, ppl_got = float(np.exp(np.mean(nll_ref))), float(np.exp(np.mean(nll_got)))
    return {"ppl_ref": ppl_ref, "ppl_quant": ppl_got,
            "ppl_rel_delta": abs(ppl_got - ppl_ref) / ppl_ref,
            "topk_overlap": float(np.mean([quality._topk_overlap(r, g, quality.TOP_K)
                                           for r, g in zip(ref_rows, got_rows)]))}


def fmt_stats(stats):
    from veomni_tpu_torch.serving import quality

    return (f"ppl {stats['ppl_ref']:.6g} -> {stats['ppl_quant']:.6g}, ppl_rel_delta "
            f"{stats['ppl_rel_delta']:.3e} (bound {quality.PPL_REL_DELTA_BOUND}), top-8 "
            f"overlap {stats['topk_overlap']:.4f} (bound {quality.TOPK_OVERLAP_BOUND})")


def scale_fault_stats(model, cfg, corpus):
    """The gate on a planted fault at full width: int8 weights whose layer-0
    ``o_proj`` scales are 4x what they should be (the CPU test plants it on
    ``down_proj``, which a MoE layer has not). Returns its stats."""
    from veomni_tpu_torch.models import decode as tdec
    from veomni_tpu_torch.ops.quantization import QuantizedWeight
    from veomni_tpu_torch.serving import quality

    dense = tdec._compute_cast(model, cfg)
    broken = tdec._compute_cast(model, cfg, weight_quant="int8")
    w = broken["layers"][0]["o_proj"]
    broken["layers"][0]["o_proj"] = QuantizedWeight(w.data, w.scale * 4.0)
    return pair_stats([quality.teacher_forced_logits(dense, cfg, t) for t in corpus],
                      [quality.teacher_forced_logits(broken, cfg, t) for t in corpus], corpus)


def quality_gate(model, cfg, tag, card, *, floor: bool):
    """The int8 tiers' quality gate on ``model`` at full width: the stats of
    each mode against the dense path on the fixed corpus, and (``floor``)
    the noise floor first: the dense bf16 path against itself at f32, no
    quantization. Where the floor is inside the bounds they judge this model
    and hold; where it breaks them, the stats are printed and the bounds are
    held on the toys they were pinned on (``gate_on_toys``). Returns
    (floor stats or None, {mode: stats})."""
    from veomni_tpu_torch.models import decode as tdec
    from veomni_tpu_torch.serving import quality

    t0 = time.perf_counter()
    corpus = quality.fixed_corpus(cfg.vocab_size)
    floor_stats = None
    if floor:
        f32 = dataclasses.replace(cfg, dtype=torch.float32)
        ref = tdec._compute_cast(model, f32)
        ref_rows = [quality.teacher_forced_logits(ref, f32, t) for t in corpus]
        del ref
        dense = tdec._compute_cast(model, cfg)
        floor_stats = pair_stats(ref_rows, [quality.teacher_forced_logits(dense, cfg, t)
                                            for t in corpus], corpus)
        GATE_FLOOR_OK[tag] = not quality.gate_failures(floor_stats)
        log(f"{tag}: quality gate noise floor (dense bf16 against itself at f32, no "
            f"quantization): {fmt_stats(floor_stats)} [{card}]")
    stats = {}
    for kv, w in SERVE_QUANT_MODES:
        stats[(kv, w)] = quality.quality_stats(model, cfg, corpus, kv_quant=kv, weight_quant=w)
        log(f"{tag}: quality gate kv_quant={kv} weight_quant={w}: {fmt_stats(stats[(kv, w)])}")
    # a model too large for the f32 pass (Qwen3-30B-A3B: 122 GB of f32
    # compute weights; K4 runs bf16 only) borrows serve_quant's dense floor,
    # and there is no gate without a floor
    if not floor and "serve quant" not in GATE_FLOOR_OK:
        raise AssertionError(f"{tag}: the quality gate has no noise floor: run serve_quant first")
    floor_ok = GATE_FLOOR_OK["serve quant" if not floor else tag]
    checks = []
    if floor_ok:
        for mode, st in stats.items():
            bad = quality.gate_failures(st)
            checks.append((f"gate kv_quant={mode[0]} weight_quant={mode[1]} at full width",
                           not bad, "; ".join(bad) or "inside the bounds"))
    else:
        log(f"{tag}: the noise floor breaks the bounds: they cannot judge this random model at "
            f"full width; the stats above are printed, the bounds are held on the toys they "
            f"were pinned on")
    fault = scale_fault_stats(model, cfg, corpus)
    checks.append(("planted 4x o_proj scale fails the gate at full width",
                   bool(quality.gate_failures(fault)), fmt_stats(fault)))
    log_checks(tag, checks)
    log(f"{tag}: quality gate in {time.perf_counter() - t0:.1f} s")
    return floor_stats, stats


def gate_on_toys(dev, card):
    """The pinned bounds on the tier-1 toys, on the card: every int8 mode
    of each toy through ``assert_quality_gate`` (block 16, the fixed
    corpus), in bf16 compute (the MoE toy's experts take K4, which runs in
    bf16). Returns {toy: {mode: stats}}."""
    from veomni_tpu_torch.models import Transformer, TransformerConfig
    from veomni_tpu_torch.serving import assert_quality_gate

    out = {}
    for name, fields in GATE_TOYS.items():
        cfg = TransformerConfig(dtype=torch.bfloat16, **fields)
        model = Transformer(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
        out[name] = {}
        for kv, w in SERVE_QUANT_MODES:
            st = assert_quality_gate(model, cfg, kv_quant=kv, weight_quant=w)
            out[name][(kv, w)] = st
            log(f"  quality gate on the {name} toy, kv_quant={kv} weight_quant={w}: "
                f"{fmt_stats(st)}: ok [{card}]")
    return out


def q8_rescore_gate(model, cfg, kv_quant: str, weight_quant: str):
    """A ``check_serve_leg`` gate for an int8 leg: each greedy token within
    eps of the row maximum of its own int8 re-score: ``teacher_forced_logits``
    on the engine's quantized parameter set, kept on the card and cut to the
    rows after the prompt."""
    from veomni_tpu_torch.models import decode as tdec
    from veomni_tpu_torch.serving import quality

    def gate(prompts, outs, eps):
        params = tdec._compute_cast(model, cfg, weight_quant=weight_quant)
        worst, n = 0.0, 0
        for p, out in zip(prompts, outs):
            rows = quality.teacher_forced_logits(params, cfg, p + out.token_ids,
                                                 kv_quant=kv_quant, on_device=True)
            rows = rows[len(p) - 1:len(p) + len(out.token_ids) - 1]
            tok = torch.tensor(out.token_ids, device=rows.device)
            mine = rows.gather(1, tok[:, None])[:, 0]
            worst = max(worst, ((rows.max(-1).values - mine) / eps).max().item())
            n += len(out.token_ids)
        return worst, n

    return gate


def quant_capacity(cfg, spec, stats_q, tag):
    """Pool bytes a block and max_concurrent_seqs at equal pool bytes, the
    int8 pool against the dense one in the compute dtype."""
    from veomni_tpu_torch.ops.quantization import kv_block_nbytes

    dense_block = kv_block_nbytes(cfg.num_hidden_layers, spec["block"], cfg.num_key_value_heads,
                                  cfg.head_dim, dtype_bytes=cfg.dtype.itemsize)
    per_seq = -(-spec["max_model_len"] // spec["block"])
    blocks = 1 + spec["slots"] * per_seq
    dense_seqs = (blocks - 1) // per_seq
    q_seqs = (int(blocks * dense_block // stats_q["block_bytes"]) - 1) // per_seq
    ratio = q_seqs / dense_seqs
    log(f"{tag}: pool bytes a block: dense {dense_block:.0f}, int8 {stats_q['block_bytes']:.0f} "
        f"(ratio {dense_block / stats_q['block_bytes']:.4f}, expected "
        f"{cfg.head_dim * cfg.dtype.itemsize}/{cfg.head_dim + 4} = "
        f"{cfg.head_dim * cfg.dtype.itemsize / (cfg.head_dim + 4):.4f}); max_concurrent_seqs at "
        f"the dense pool's {blocks * dense_block / 2**30:.3f} GiB: dense {dense_seqs}, int8 "
        f"{q_seqs} ({ratio:.3f}x)")
    return ratio


def int8_legs(model, cfg, dev, card, prompts, spec, tag, modes, *, spread, want=None):
    """One engine leg a mode: every token against its own int8 re-score, no
    leaked block, pools unmoved, cached tokens within the shared prefix,
    launches as ``want(stats)`` reckons them. Returns {mode: stats}."""
    out = {}
    for kv, w in modes:
        leg = f"{tag} int8 leg kv_quant={kv} weight_quant={w}"
        outs, stats = serve_leg(model, cfg, dev, card, prompts, spec, leg, kv_quant=kv,
                                weight_quant=w)
        check_serve_leg(leg, model, prompts, outs, stats, spread, spec["max_new"],
                        allowed_cached=shared_blocks(prompts, spec["block"]),
                        want_launches=want(stats) if want else None,
                        gate=q8_rescore_gate(model, cfg, kv, w))
        out[(kv, w)] = stats
    return out


def phase_serve_quant(dev, card):
    """The int8 tiers at Qwen3-0.6B, all 28 layers in bf16: the quality
    gate (noise floor first), the bounds on the toys where the floor breaks
    them, then the engine over SERVE_DENSE's 8 requests in each int8
    mode, and the capacity the int8 pool buys. Returns the legs' launches
    (none: the dense decode path runs no hand kernel)."""
    from veomni_tpu_torch.models import Transformer
    from veomni_tpu_torch.models import decode as tdec
    from veomni_tpu_torch.train_text_step import SEED, bench_config

    host_state("serve quant")
    spec = SERVE_QUANT
    cfg = bench_config(SERVE_DENSE_PRESET, param_dtype="bfloat16")
    model = Transformer(cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev)
    quality_gate(model, cfg, "serve quant", card, floor=True)
    if not GATE_FLOOR_OK["serve quant"]:
        gate_on_toys(dev, card)
    prompts = serve_traffic(cfg.vocab_size, SERVE_DENSE)[:spec["requests"]]
    log(f"serve quant: Qwen3-0.6B ({cfg.num_hidden_layers} layers, bf16 weights from seed "
        f"{SEED}); {len(prompts)} of serve dense's requests, {spec['max_new']} new tokens "
        f"each, waves of {spec['wave']} [{card}]")
    spread = first_token_spread(model, cfg, tdec._compute_cast(model, cfg), prompts,
                                "serve dense")
    legs = int8_legs(model, cfg, dev, card, prompts, spec, "serve quant", SERVE_QUANT_MODES,
                     spread=spread)
    ratio = quant_capacity(cfg, spec, legs[("int8", "none")], "serve quant")
    log_checks("serve quant", [("capacity", ratio >= 1.8,
                                f"{ratio:.3f}x the dense pool's max_concurrent_seqs")])
    summary = {f"{kv}/{w}": {k: v for k, v in st.items() if k not in (
        "cached_tokens", "launches", "fallbacks")} for (kv, w), st in legs.items()}
    log("serve quant summary: " + json.dumps(summary))
    launches = {}
    for st in legs.values():
        for k, v in st["launches"].items():
            launches[k] = launches.get(k, 0) + v
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# 8 requests in waves of 4 (16 and 8 until the parallel phase joined the script)
ROUTER_SPEC = dict(SERVE_DENSE, slots=8, requests=8, wave=4, max_new=24)
ROUTER_BURST_LEN = 640  # probation bursts: the shared prefix and 128 tokens
# the hang drill's wedge deadline: at 1 s healthy replicas were declared
# wedged too (a tick on one shared card with a respawn's weight copy on the
# router thread ran past it), at 3 s only the hung one is
ROUTER_STALL_S = 3.0
ROUTER_HANG_S = 10.0


def router_requests(prompts, max_new):
    from veomni_tpu_torch.serving import Request, SamplingParams

    return [Request(prompt_ids=list(p), sampling=SamplingParams(max_new_tokens=max_new))
            for p in prompts]


def drive_router(router, prompts, spec, *, on_tick=None):
    """Submit ``prompts`` in two waves ``wave_ticks`` ticks apart and drain;
    returns (request ids in submit order, outputs by id, ticks, seconds)."""
    reqs = router_requests(prompts, spec["max_new"])
    t0 = time.perf_counter()
    ids = [router.submit(r) for r in reqs[:spec["wave"]]]
    ticks = 0
    for _ in range(spec["wave_ticks"]):
        router.step()
        ticks += 1
        if on_tick:
            on_tick(ticks)
    ids += [router.submit(r) for r in reqs[spec["wave"]:]]
    while router.has_work:
        router.step()
        ticks += 1
        if on_tick:
            on_tick(ticks)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    outs = router.run()
    return ids, outs, ticks, wall


def probation_burst(router, prompt, max_new: int, timeout_s: float = 60.0):
    """Drive pending respawns to landing and probation replicas to parole
    with bursts of one prompt (they saturate its affinity target, so the
    spill reaches the probationer); returns the burst's outputs."""
    from veomni_tpu_torch.serving.replica import STATE_PROBATION

    done = {}
    deadline = time.perf_counter() + timeout_s
    while time.perf_counter() < deadline:
        probation = [h for h in router.replicas.values() if h.state == STATE_PROBATION]
        if (len(router.live_replicas()) >= router.config.replicas
                and not router._pending_respawns and not probation and not router.has_work):
            return done
        if router.has_work or router._pending_respawns:
            router.step()
            continue
        burst = (router.engine_config.num_slots + router.config.spill_queue_depth
                 + router.config.probation_requests * max(1, len(probation)))
        for r in router_requests([prompt[:ROUTER_BURST_LEN]] * burst, max_new):
            router.submit(r)
        done.update(router.run())
    raise AssertionError("the fleet did not restore within the timeout")


def gate_outputs(model, prompts, outs, eps):
    """The re-score gate over whatever tokens each output holds (a
    cancelled request keeps the tokens it streamed)."""
    kept = [(p, o) for p, o in zip(prompts, outs) if o.token_ids]
    return rescore_gate(model, [p for p, _ in kept], [o for _, o in kept], {}, eps)


def write_generation(dev, cfg, root: str, step: int, seed: int):
    """A port checkpoint generation (``Checkpointer``, before the
    optimizer's first step: no moments) of a second random weight set;
    returns (its directory, the model)."""
    from veomni_tpu_torch.checkpoint.checkpointer import Checkpointer
    from veomni_tpu_torch.models import Transformer
    from veomni_tpu_torch.optim.optimizer import build_optimizer
    from veomni_tpu_torch.train.train_step import build_train_state

    model = Transformer(cfg, torch.Generator(device=dev).manual_seed(seed), device=dev)
    ckpt = Checkpointer(root, async_save=False)
    ckpt.save(step, build_train_state(model, build_optimizer(model, lr=1e-4)))
    ckpt.close()
    return os.path.join(root, f"global_step_{step}"), model


# the chaos soak over the router phase's two replicas: a kill at 0.92 s and
# a publish at 2.72 s of a 4 s storm, two 20 ms delays (seed 6 of
# build_chaos_plan with these counts); 12 requests at once, then 8 spread
# over 0.5-3 s, 24 new tokens each (halved with the storm when the parallel
# phase joined the script: 40 requests over 8 s took ~25 s)
CHAOS_SEED = 6
CHAOS_PLAN = dict(duration_s=4.0, kills=1, hangs=0, delays=2, exceptions=0, publishes=1,
                  expected_ticks=200)
CHAOS_BURST, CHAOS_SPREAD = 12, 8


def router_exporter_and_soak(router, model, cfg, card):
    """The exporter over the router (``/healthz``, ``/debug/router`` read
    over HTTP), then a seeded ``run_chaos_soak`` over the same fleet with a
    replica kill and a weight publish: every id completes exactly once, no
    block leaks, the fleet restored, every replica on the published
    version; its goodput is logged, not gated. Returns the checks."""
    from veomni_tpu_torch.observability.exporter import MetricsExporter
    from veomni_tpu_torch.resilience.chaos import build_chaos_plan, run_chaos_soak
    from veomni_tpu_torch.serving import host_state

    exp = MetricsExporter(port=0, host="127.0.0.1", health_fn=router.health,
                          router_fn=router.debug_doc)
    port = exp.start()
    try:
        got = scrape_routes(port, ("/healthz", "/debug/router"))
    finally:
        exp.stop()
    health, doc = (json.loads(got[r][1]) if got[r][0] == 200 else {}
                   for r in ("/healthz", "/debug/router"))
    log(f"serve router exporter: /healthz {got['/healthz'][0]} {json.dumps(health)}; "
        f"/debug/router {got['/debug/router'][0]}, replicas "
        f"{[(r.get('rid'), r.get('state'), r.get('weights_version')) for r in doc.get('replicas', [])]}")
    checks = [
        ("exporter /healthz", got["/healthz"][0] == 200 and health.get("healthy") is True,
         f"{got['/healthz'][0]} {health}"),
        ("exporter /debug/router", got["/debug/router"][0] == 200
         and len(doc.get("replicas", [])) == 2, f"{len(doc.get('replicas', []))} replicas"),
    ]
    plan = build_chaos_plan(CHAOS_SEED, **CHAOS_PLAN)
    prompts = serve_traffic(cfg.vocab_size, dict(SERVE_DENSE, requests=CHAOS_BURST
                                                 + CHAOS_SPREAD), seed=2)
    reqs = router_requests(prompts, ROUTER_SPEC["max_new"])
    arrivals = [0.0] * CHAOS_BURST + [0.5 + 2.5 * i / CHAOS_SPREAD for i in range(CHAOS_SPREAD)]
    payload = host_state(model)
    redispatched = router.metrics()["redispatched"]
    census = census_mark()
    report = run_chaos_soak(
        router_factory=lambda: router, requests=reqs, arrivals=arrivals, plan=plan,
        publish_fn=lambda r, idx: r.publish_weights(payload, f"chaos-v{idx + 1}"),
        restore_timeout_s=120.0)
    moved = router.metrics()["redispatched"] - redispatched
    outs = [report["outputs"][i] for i in sorted(report["outputs"])]
    finished = all(o.finished for o in outs)
    log(f"serve router chaos soak (seed {CHAOS_SEED}: {json.dumps(plan.to_doc())}): "
        f"{report['submitted']} submitted, {report['completed']} completed, lost "
        f"{report['lost_ids']}, {moved:.0f} redispatched, wedged {report['wedged']}, respawns "
        f"{report['respawns']}, probations passed {report['probation_passed']}, "
        f"{report['probe_submitted']} probes; {report['duration_s']:.2f} s of storm, goodput "
        f"{report['goodput_tok']} tokens, {report['goodput_tok_s']:.1f} tok/s (not gated; "
        f"{census_note(census)}); "
        f"published {report['published_versions']} in {report['publish_wall_s']:.2f} s, serving "
        f"{report['serving_versions']} [{card}]")
    checks += [
        ("chaos soak exactly once", report["submitted"] == len(reqs) and not report["lost_ids"]
         and not report["duplicated"] and report["completed"] == len(reqs) and finished,
         f"{report['completed']} of {report['submitted']} ids, lost {report['lost_ids']}"),
        ("chaos soak block leak", not report["leaked_blocks"], str(report["leaked_blocks"])),
        ("chaos soak fleet restored", report["restored"] and not report["stalled"]
         and report["respawns"] >= 1, f"live {report['live_count']}, respawns "
         f"{report['respawns']}"),
        ("chaos soak published version", report["version_converged"]
         and report["serving_versions"] == ["chaos-v1"]
         and all(h.weights_version == "chaos-v1" for h in router.replicas.values()),
         f"{ {h.rid: h.weights_version for h in router.replicas.values()} }"),
        ("chaos soak invariants", report["invariants_ok"], "run_chaos_soak's own verdict"),
    ]
    return checks


def phase_serve_router(dev, card):
    """Two replicas of Qwen3-0.6B (bf16, 28 layers) behind the router on
    serve dense's shared-prefix traffic: a one-engine run of the same
    traffic first; then the fleet with a ``raise`` at ``serve.decode_tick``
    on one replica (its unstreamed requests redispatched, its streamed ones
    cancelled, a respawn into probation and out of it); a ``hang`` there
    under a short ``replica_stall_s`` (the replica wedges, respawns and
    serves probation); a rolling ``publish_from_checkpoint`` of a second
    weight set mid-traffic after a truncated copy of it is refused. Every
    token passes the re-score gate of the weights it ran on; every request
    id finishes exactly once."""
    from veomni_tpu_torch.models import Transformer
    from veomni_tpu_torch.models import decode as tdec
    from veomni_tpu_torch.resilience.faults import configure_faults, disarm_faults
    from veomni_tpu_torch.resilience.integrity import CheckpointCorruptError
    from veomni_tpu_torch.serving import EngineConfig, Router, RouterConfig
    from veomni_tpu_torch.train_text_step import SEED, bench_config

    host_state("serve router")
    spec = ROUTER_SPEC
    cfg = bench_config(SERVE_DENSE_PRESET, param_dtype="bfloat16")
    model = Transformer(cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev)
    prompts = serve_traffic(cfg.vocab_size, SERVE_DENSE)[:spec["requests"]]
    spread = first_token_spread(model, cfg, tdec._compute_cast(model, cfg), prompts,
                                "serve dense")
    eps = spread[1]
    ec = EngineConfig(num_slots=spec["slots"], block_size=spec["block"],
                      max_model_len=spec["max_model_len"], prefill_chunk=SERVE_CHUNK)
    # the one-engine run of the same traffic
    outs1, stats1 = serve_leg(model, cfg, dev, card, prompts, spec, "serve router one engine")
    check_serve_leg("serve router one engine", model, prompts, outs1, stats1, spread,
                    spec["max_new"], allowed_cached=shared_blocks(prompts, spec["block"]))
    t_build = time.perf_counter()
    router = Router(model, cfg, ec, RouterConfig(
        replicas=2, spill_queue_depth=2, max_respawns=3, respawn_backoff_s=0.05,
        respawn_backoff_max_s=0.2, probation_requests=2), device=dev)
    log(f"serve router: 2 replicas of Qwen3-0.6B ({spec['slots']} slots, block {spec['block']}, "
        f"chunks of {SERVE_CHUNK}) built in {time.perf_counter() - t_build:.1f} s; "
        f"{len(prompts)} requests, {spec['max_new']} new tokens each, waves of {spec['wave']}; "
        f"each replica ticks on a pump thread of its own, on the card's default stream [{card}]")
    # the affinity key: crc32 of the prompt's leading RouterConfig.affinity_blocks
    # full blocks (the whole prompt when shorter than one), and its rendezvous
    # target: the replica whose crc32 of "key:rid" is largest (the
    # reference's rule, written out here independently of the router)
    def own_target(p):
        bs, n = spec["block"], min(router.config.affinity_blocks, len(p) // spec["block"])
        chunks = (tuple(int(t) for t in p) if n <= 0 else
                  tuple(tuple(int(t) for t in p[i * bs:(i + 1) * bs]) for i in range(n)))
        key = zlib.crc32(repr(chunks).encode())
        return key, max(router.live_replicas(),
                        key=lambda h: (zlib.crc32(f"{key}:{h.rid}".encode()), h.rid)).rid

    mismatched = [i for i, p in enumerate(prompts) if own_target(p) != (
        router._affinity_key(p), router._affinity_target(router._affinity_key(p),
                                                         router.live_replicas()).rid)]
    targets = [own_target(p)[1] for p in prompts]
    checks = [("affinity", not mismatched,
               f"keys and rendezvous targets of {len(prompts)} prompts against the script's own "
               f"(targets {dict((r, targets.count(r)) for r in sorted(set(targets)))}; "
               f"{len(mismatched)} mismatched, the first {mismatched[:4]})")]
    reset_all_counts()
    # (0) the fleet with no fault: aggregate throughput against one engine
    census = census_mark()
    ids, outs, ticks, wall = drive_router(router, prompts, spec)
    by_id = [outs[i] for i in ids]
    m = router.metrics()
    ratio, n = gate_outputs(model, prompts, by_id, eps)
    tok_s = sum(len(o.token_ids) for o in by_id) / wall
    log(f"serve router fleet, no fault: {len(by_id)} requests in {ticks} router ticks, "
        f"{wall:.2f} s, {tok_s:.1f} tok/s aggregate against one engine's "
        f"{stats1['generated'] / stats1['wall_s']:.1f} ({stats1['wall_s']:.2f} s); spills "
        f"{m['spills']:.0f}, hit rate {m['prefix_hit_rate']:.4f} against one engine's "
        f"{stats1['prefix_hit_rate']:.4f}; dispatched "
        f"{ {h.rid: h.dispatched for h in router.replicas.values()} }; {census_note(census)} "
        f"[{card}]")
    checks += [
        ("no fault: exactly once", sorted(outs) == sorted(ids) and all(
            o.finish_reason == "length" and len(o.token_ids) == spec["max_new"] for o in by_id),
         f"{len(outs)} outputs for {len(ids)} ids"),
        ("no fault: re-score gate", ratio <= 1.0,
         f"worst (gap / eps) = {ratio:.4f} over {n} tokens"),
    ]
    # (1) a raise at a replica's first decode tick: it dies mid-storm. The
    # traffic is 12 prompts of another seed behind one shared prefix (a cold
    # cache; one affinity key) with spill off, so all of it lands on one
    # replica: 8 in its slots, the rest waiting unstreamed when it dies
    prompts = serve_traffic(cfg.vocab_size, dict(SERVE_DENSE, requests=24), seed=1)[::2]
    router.config.spill_queue_depth = 0
    configure_faults([{"point": "serve.decode_tick", "mode": "exception", "hit": 1}])
    census = census_mark()
    try:
        ids, outs, ticks, wall = drive_router(router, prompts, dict(
            spec, wave=len(prompts), wave_ticks=0))
    finally:
        disarm_faults()
        router.config.spill_queue_depth = 2
    launches, fallbacks = read_counts()
    m = router.metrics()
    by_id = [outs[i] for i in ids]
    done = [o for o in by_id if o.finish_reason == "length"]
    cancelled = [o for o in by_id if o.finish_reason == "cancelled"]
    ratio, n = gate_outputs(model, prompts, by_id, eps)
    tok_s = sum(len(o.token_ids) for o in by_id) / wall
    log(f"serve router fleet, a raise at a decode tick: {len(by_id)} requests in {ticks} router "
        f"ticks, {wall:.2f} s, {tok_s:.1f} tok/s aggregate; spills {m['spills']:.0f} (the run's "
        f"total), redispatched {m['redispatched']:.0f}, cancelled "
        f"{len(cancelled)}, respawns {m['respawns']:.0f}; retired "
        f"{[(h.rid, h.state, h.fail_reason[:60]) for h in router.retired]}; launches {launches}; "
        f"{census_note(census)}")
    checks += [
        ("exactly once", sorted(outs) == sorted(ids) and len(set(ids)) == len(ids)
         and all(o.finished for o in by_id), f"{len(outs)} outputs for {len(ids)} ids"),
        ("raise", len(router.retired) == 1 and router.retired[0].state == "dead"
         and m["redispatched"] >= 1, f"one replica dead, {m['redispatched']:.0f} redispatched"),
        ("outcomes", len(done) + len(cancelled) == len(by_id)
         and all(len(o.token_ids) == spec["max_new"] for o in done),
         f"{len(done)} finished at max_new, {len(cancelled)} cancelled after streaming"),
        ("re-score gate", ratio <= 1.0, f"worst (gap / eps) = {ratio:.4f} over {n} tokens"),
        ("launches", not any(launches.values()) and not any(fallbacks.values()),
         f"{launches}, FALLBACK_CALLS {fallbacks}"),
    ]
    # (2) the respawn serves its probation on spill traffic
    burst = probation_burst(router, prompts[0], spec["max_new"])
    checks.append(("probation after the raise", router._probation_total >= 1
                   and len(router.live_replicas()) == 2,
                   f"{router._respawn_total} respawn(s), {router._probation_total} probation(s) "
                   f"passed over a burst of {len(burst)} requests"))
    # (3) a hang: one replica's decode tick sleeps past replica_stall_s
    router.config.replica_stall_s = ROUTER_STALL_S
    configure_faults([{"point": "serve.decode_tick", "mode": "hang", "hit": 1,
                       "seconds": ROUTER_HANG_S}])
    t_hang = time.perf_counter()
    t_wedge = None

    def watch(_):
        nonlocal t_wedge
        if t_wedge is None and router._wedged_total:
            t_wedge = time.perf_counter()

    try:
        ids, outs, _, _ = drive_router(router, prompts[:spec["wave"]], dict(spec, wave_ticks=0),
                                       on_tick=watch)
    finally:
        disarm_faults()
    by_id = [outs[i] for i in ids]
    ratio, n = gate_outputs(model, prompts, by_id, eps)
    burst = probation_burst(router, prompts[0], spec["max_new"])
    detect = (t_wedge - t_hang) if t_wedge else float("inf")
    log(f"serve router hang: wedged {router._wedged_total} in {detect:.2f} s (replica_stall_s "
        f"{ROUTER_STALL_S}, {router.config.replica_stall_ticks} strikes, hang {ROUTER_HANG_S} s); "
        f"respawns {router._respawn_total}, probations passed {router._probation_total}")
    checks += [
        ("hang", router._wedged_total == 1 and detect < ROUTER_HANG_S,
         f"one wedge, declared after {detect:.2f} s"),
        ("hang exactly once", sorted(outs) == sorted(ids) and all(o.finished for o in by_id),
         f"{len(outs)} outputs for {len(ids)} ids"),
        ("hang re-score gate", ratio <= 1.0, f"worst (gap / eps) = {ratio:.4f} over {n} tokens"),
        ("probation after the hang", router._probation_total >= 2
         and len(router.live_replicas()) == 2, f"{router._probation_total} passed"),
    ]
    router.config.replica_stall_s = 60.0
    # (4) publication: a truncated generation is refused, the good one rolls
    hf_tmp = tempfile.mkdtemp(prefix="chip_smoke_publish_")
    try:
        step_dir, model2 = write_generation(dev, cfg, hf_tmp, 1, SEED + 1)
        bad = os.path.join(hf_tmp, "global_step_2")
        shutil.copytree(step_dir, bad)
        os.truncate(os.path.join(bad, "train_state", "model.pt"), 4096)
        versions = {h.rid: h.weights_version for h in router.replicas.values()}
        try:
            router.publish_from_checkpoint(bad)
            refused = False
        except CheckpointCorruptError:
            refused = True
        checks.append(("truncated generation refused", refused and versions == {
            h.rid: h.weights_version for h in router.replicas.values()}
            and router.weights_version == "v0", f"versions {versions}"))
        before = router_requests(prompts[:spec["wave"]], spec["max_new"])
        ids_before = [router.submit(r) for r in before]
        while router._queue:  # every one of them dispatched on v0 before the publish
            router.step()
        cached = {h.rid: h.engine.blocks.num_cached for h in router.replicas.values()}
        t_pub = time.perf_counter()
        version = router.publish_from_checkpoint(step_dir)
        while router.publish_in_progress:
            router.step()
        roll_s = time.perf_counter() - t_pub
        # the swap flushes each prefix cache (the v0 KV must not serve v1);
        # the v0 requests that ran on after their replica swapped did not
        # exist: each replica drained before its swap
        checks.append(("publish flushed the prefix caches", all(
            h.engine.blocks.num_cached == 0 for h in router.replicas.values()),
            f"cached blocks before the roll {cached}, after "
            f"{ {h.rid: h.engine.blocks.num_cached for h in router.replicas.values()} }"))
        after = router_requests(prompts[spec["wave"]:], spec["max_new"])
        ids_after = [router.submit(r) for r in after]
        outs = router.run()
        ratio_b, n_b = gate_outputs(model, prompts[:spec["wave"]],
                                    [outs[i] for i in ids_before], eps)
        ratio_a, n_a = gate_outputs(model2, prompts[spec["wave"]:],
                                    [outs[i] for i in ids_after], eps)
        log(f"serve router publish: {version} rolled into the fleet in {roll_s:.2f} s while "
            f"{len(ids_before)} requests ran on v0; replicas "
            f"{[(h.rid, h.weights_version, h.engine.cache_epoch) for h in router.replicas.values()]}")
        checks += [
            ("publish", all(h.weights_version == version for h in router.replicas.values()),
             f"every replica on {version}"),
            ("before the roll: gate on the old weights", ratio_b <= 1.0,
             f"worst {ratio_b:.4f} over {n_b} tokens"),
            ("after the roll: gate on the published weights", ratio_a <= 1.0,
             f"worst {ratio_a:.4f} over {n_a} tokens"),
            ("publish exactly once", sorted(outs) == sorted(ids_before + ids_after),
             f"{len(outs)} outputs"),
        ]
        health = router.health()
        log(f"serve router health: {json.dumps(health)}")
        for h in router.replicas.values():
            bm = h.engine.blocks
            checks.append((f"{h.rid} block leak", bm.num_used == 0
                           and bm.num_free_uncached + bm.num_cached == bm.num_blocks - 1,
                           "free_uncached + cached == pool - null"))
        del model2
    finally:
        shutil.rmtree(hf_tmp, ignore_errors=True)
    checks += router_exporter_and_soak(router, model, cfg, card)
    log_checks("serve router", checks)
    del router, model
    gc.collect()
    torch.cuda.empty_cache()
    return launches


INFER_PROMPTS = ("the engine serves every request", "hello there")
INFER_MAX_NEW = 64


def infer_config_fields(vocab: int):
    """Qwen3-0.6B's fields (``train_text_step.bench_config``) for a
    ``model.config_overrides``, with the fixture tokenizer's vocab."""
    from veomni_tpu_torch.train_text_step import BENCH_PRESETS

    return dict(model_type="qwen3", vocab_size=vocab, num_attention_heads=16,
                num_key_value_heads=8, head_dim=128, qk_norm=True, tie_word_embeddings=True,
                max_position_embeddings=131072, rope_theta=1e6,
                **{k: v for k, v in BENCH_PRESETS[SERVE_DENSE_PRESET].items()})


def start_infer_text():
    """Start ``python -m veomni_tpu_torch.tasks.infer_text`` as a
    subprocess on Qwen3-0.6B (28 layers, random weights from seed 0, the
    embedding cut to the byte-fallback fixture tokenizer's 4096 ids) with
    two prompts on its stdin; returns what ``finish_infer_text`` needs.
    The whole run starts it before the kernel build (which runs on the
    host; the subprocess needs no hand kernel) and finishes it before the
    first timed phase, so it never shares the card with a timing. A
    watcher thread notes the moment the subprocess exits."""
    from veomni_tpu_torch.models.auto import build_tokenizer

    tok_dir = os.path.join(TOKENIZER_FIXTURES, "bytefallback")
    tok = build_tokenizer(tok_dir)
    fields = infer_config_fields(len(tok))
    out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
    proc = subprocess.Popen(
        [sys.executable, "-m", "veomni_tpu_torch.tasks.infer_text",
         "--model.config_overrides=" + json.dumps(fields), f"--model.tokenizer_path={tok_dir}"],
        stdin=subprocess.PIPE, stdout=out, stderr=err, text=True)
    t0 = time.perf_counter()
    proc.stdin.write("".join(p + "\n" for p in INFER_PROMPTS))
    proc.stdin.close()
    ended = []
    watcher = threading.Thread(target=lambda: (proc.wait(), ended.append(time.perf_counter())),
                               daemon=True)
    watcher.start()
    return proc, t0, watcher, ended, tok, fields, out, err


def finish_infer_text(dev, card, started):
    """Collect the subprocess's output: each printed line must be the decode
    of ``greedy_generate``'s ids for the same prompt on the same weights."""
    from veomni_tpu_torch.models import Transformer, TransformerConfig
    from veomni_tpu_torch.models.decode import greedy_generate

    proc, t0, watcher, ended, tok, fields, out, err = started
    proc.wait(timeout=600)
    watcher.join()
    wall = ended[0] - t0
    out.seek(0)
    err.seek(0)
    got = out.read()
    if proc.returncode != 0:
        raise AssertionError(f"infer_text exited {proc.returncode}: {err.read()[-2000:]}")
    model = Transformer(TransformerConfig(**fields), torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    want = ["enter prompt (ctrl-d to exit):"] + [
        tok.decode(greedy_generate(model, model.cfg, tok(p)["input_ids"],
                                   max_new_tokens=INFER_MAX_NEW, eos_id=tok.eos_token_id))
        for p in INFER_PROMPTS]
    log(f"infer_text: subprocess on Qwen3-0.6B ({fields['num_hidden_layers']} layers, vocab "
        f"{fields['vocab_size']}), {len(INFER_PROMPTS)} prompts, ran {wall:.1f} s from its start "
        f"to its exit [{card}]")
    log_checks("infer_text", [("ids", got == "".join(w + "\n" for w in want),
                               f"its lines against greedy_generate's decode: {got[-300:]!r}")])
    del model
    torch.cuda.empty_cache()


def phase_infer_text(dev, card):
    """``start_infer_text`` then ``finish_infer_text`` (a ``--phases`` run)."""
    finish_infer_text(dev, card, start_infer_text())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="",
                    help="run only these phases after the build, in order: serve_dense, "
                         "serve_moe, hf_trainer_gemma3, serve_gemma3, dialects, "
                         "hf_trainer_moonlight, deepseek_v2_lite, hf_trainer_gpt_oss, "
                         "serve_gpt_oss, sft_lora_dense, sft_lora_moe, hf_trainer_qwen2_vl, "
                         "hf_trainer_qwen2_5_vl, moe (with the MoE monitor), post_training, "
                         "remat, serve_quant, serve_router, infer_text, parallel (two ranks "
                         "on the card), vlm_witness and parallel_floor (measurements "
                         "outside the whole run), and before them main "
                         "(the dense loop) or trainer; such a partial run prints no result "
                         "line")
    args = ap.parse_args(argv)
    names = args.phases.split(",") if args.phases else []
    if "serve_moe" in names and "serve_quant" not in names[:names.index("serve_moe")]:
        ap.error("serve_moe's quality gate reads serve_quant's noise floor: "
                 "name serve_quant before it")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on an NVIDIA GPU", file=sys.stderr)
        return 1
    from veomni_tpu_torch.ops.cuda import flash_attention as fa
    from veomni_tpu_torch.ops.cuda import grouped_gemm as gg
    from veomni_tpu_torch.ops.cuda import probe
    from veomni_tpu_torch.utils.device import resolve_device

    dev = resolve_device("cuda")
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    # the whole run's infer_text subprocess runs while the kernels build
    infer = None if args.phases else start_infer_text()
    try:
        phase_build([probe.SOURCE, fa.SOURCE, gg.SOURCE])
    except BaseException:
        if infer is not None:
            infer[0].kill()
        raise
    if args.phases:
        phases = {"main": phase_main, "trainer": phase_trainer,
                  "serve_dense": phase_serve_dense, "serve_moe": phase_serve_moe,
                  "hf_trainer_gemma3": phase_hf_trainer_gemma3,
                  "serve_gemma3": phase_serve_gemma3, "dialects": phase_dialects,
                  "hf_trainer_moonlight": phase_hf_trainer_moonlight,
                  "deepseek_v2_lite": phase_deepseek_v2_lite,
                  "sft_lora_dense": phase_sft_lora_dense, "sft_lora_moe": phase_sft_lora_moe,
                  "hf_trainer_gpt_oss": phase_hf_trainer_gpt_oss,
                  "serve_gpt_oss": phase_serve_gpt_oss,
                  "hf_trainer_qwen2_vl": phase_hf_trainer_qwen2_vl,
                  "hf_trainer_qwen2_5_vl": phase_hf_trainer_qwen2_5_vl,
                  "moe": phase_moe_main, "post_training": phase_post_training,
                  "remat": phase_remat, "serve_quant": phase_serve_quant,
                  "serve_router": phase_serve_router, "infer_text": phase_infer_text,
                  "vlm_witness": phase_vlm_witness, "parallel": phase_parallel,
                  "parallel_floor": phase_parallel_floor}
        for name in names:
            t0 = time.perf_counter()
            phases[name](dev, card)
            torch.cuda.empty_cache()
            log(f"phase clock: {name} took {time.perf_counter() - t0:.1f} s")
        log(f"phases {args.phases} passed (a partial run: no result line)")
        return 0
    hf_tmp = tempfile.mkdtemp(prefix="chip_smoke_hf_")
    try:
        return run_phases(dev, card, hf_tmp, infer)
    finally:
        if infer[0].poll() is None:
            infer[0].kill()
        shutil.rmtree(hf_tmp, ignore_errors=True)


def lap_clock(name: str, since: float) -> float:
    """Log the seconds since ``since`` as phase ``name``'s; return now."""
    now = time.perf_counter()
    log(f"phase clock: {name} took {now - since:.1f} s")
    return now


def run_phases(dev, card, hf_tmp, infer) -> int:
    from veomni_tpu_torch.train_text_step import packed_batches

    # the subprocess ran beside the kernel build; it ends before any timing
    lap = time.perf_counter()
    finish_infer_text(dev, card, infer)
    lap_clock("infer_text (its wait and check after the kernel build)", lap)
    t0 = time.perf_counter()
    table = [phase_probe(dev)]
    # the dense main path's first packed micro-batch: the kernels' real segment layout
    seg = torch.from_numpy(next(packed_batches(151936, 4096, 4))["segment_ids"][0]).to(dev)
    flash = phase_flash(dev, seg, 16, 8, "Qwen3-0.6B layout")
    torch.cuda.empty_cache()
    # the same batch at the MoE model's head layout, as the MoE main path runs it
    moe_rows = phase_flash(dev, seg, 32, 4, "Qwen3-30B-A3B layout")
    torch.cuda.empty_cache()
    # its first row alone: micro-batch 1, where K2 splits the q-head group
    mb1_rows = phase_flash(dev, seg[:1].contiguous(), 32, 4, "Qwen3-30B-A3B, micro-batch 1")
    for row, moe, mb1 in zip(flash, moe_rows, mb1_rows):
        row["moe_layout"] = {k: moe[k] for k in LAYOUT_KEYS}
        row["moe_micro_batch_1"] = {k: mb1[k] for k in LAYOUT_KEYS}
    table += flash
    torch.cuda.empty_cache()
    phase_flash_edges(dev)
    # head dim 64 on the HF trainer phase's own first packed batch
    # (TinyLlama-1.1B: 32 q / 4 kv heads), and its first row alone (K2 splits
    # each group of 8 q heads over 8 work items)
    hf_yaml = write_hf_run(hf_tmp)
    hf_batch = hf_first_batch(hf_yaml)
    hf_seg = torch.from_numpy(hf_batch["segment_ids"][0]).to(dev)
    d64 = phase_flash(dev, hf_seg, 32, 4, "TinyLlama-1.1B layout", d=64)
    torch.cuda.empty_cache()
    d64_mb1 = phase_flash(dev, hf_seg[:1].contiguous(), 32, 4, "TinyLlama-1.1B, micro-batch 1",
                          d=64)
    for row, mb1 in zip(d64, d64_mb1):
        row["micro_batch_1"] = {k: mb1[k] for k in LAYOUT_KEYS}
    table += d64
    torch.cuda.empty_cache()
    # head dim 256 at Gemma-7B's heads (16 q, 16 kv) on the dense batch's first row
    table += phase_flash(dev, seg[:1].contiguous(), 16, 16, "Gemma-7B heads, S=4096", d=256)
    torch.cuda.empty_cache()
    lap = lap_clock("flash and edge-case kernel checks", t0)
    table += phase_gmm(dev)
    torch.cuda.empty_cache()
    lap = lap_clock("grouped-GEMM kernel checks", lap)
    # each main path with the head dim its attention runs at, and the
    # preset whose layout rows count it (None: the rows above)
    by_path = {"dense": (phase_main(dev, card), 128, None)}
    torch.cuda.empty_cache()
    lap = lap_clock("main", lap)
    # the bare loop under every remat policy and chunk_mbs, then under every
    # optimizer of build_optimizer (K1-K3 at D 128)
    remat, optimizers = phase_remat(dev, card)
    by_path["remat"] = (remat, 128, None)
    by_path["optimizers"] = (optimizers, 128, None)
    torch.cuda.empty_cache()
    lap = lap_clock("remat", lap)
    by_path["trainer"] = (phase_trainer(dev, card), 128, None)
    torch.cuda.empty_cache()
    lap = lap_clock("trainer", lap)
    by_path["hf_trainer"] = (phase_hf_trainer(dev, card, hf_yaml, hf_batch), 64, None)
    torch.cuda.empty_cache()
    lap = lap_clock("hf_trainer", lap)
    moe_launches, monitor_launches = phase_moe_main(dev, card)
    by_path["moe"] = (moe_launches, 128, None)
    by_path["moe_monitor"] = (monitor_launches, 128, None)
    torch.cuda.empty_cache()
    lap = lap_clock("moe", lap)
    phase_moe_micro_batch_1(dev, card)
    lap = lap_clock("moe micro-batch 1", lap)
    phase_parity(dev)
    phase_moe_parity(dev)
    lap = lap_clock("parity", lap)
    # the parallel layer: two ranks on the card (K1-K3 at D 128 in the dense
    # leg, K4-K6 and K1-K3 in the MoE one)
    paths, ulysses_rows = phase_parallel(dev, card)
    for path, launches in paths.items():
        by_path[path] = (launches, 128, None)
    for row, uly in zip(flash, ulysses_rows):
        row["ulysses_layout"] = {k: uly[k] for k in LAYOUT_KEYS}
    gc.collect()
    torch.cuda.empty_cache()
    lap = lap_clock("parallel", lap)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase clock: {time.perf_counter() - t0:.1f} s to the dialect phases")
    # the dense HF dialects and the deepseek MoE dialect, each path followed
    # by its kernel rows
    for phase in (phase_hf_trainer_gemma3, phase_dialects, phase_hf_trainer_moonlight,
                  phase_deepseek_v2_lite, phase_hf_trainer_gpt_oss):
        t_phase = time.perf_counter()
        paths, rows = phase(dev, card)
        log(f"phase clock: {phase.__name__} took {time.perf_counter() - t_phase:.1f} s")
        by_path.update(paths)
        table += rows
        gc.collect()
        torch.cuda.empty_cache()
    log(f"phase clock: {time.perf_counter() - t0:.1f} s to the serving phases")
    lap = time.perf_counter()
    by_path["serve_dense"] = (phase_serve_dense(dev, card), 128, None)
    lap = lap_clock("serve_dense", lap)
    # the int8 tiers and their gate (before serve_moe, which reads the gate's
    # noise floor) and the router: Qwen3-0.6B, no hand kernel
    by_path["serve_quant"] = (phase_serve_quant(dev, card), 128, None)
    lap = lap_clock("serve_quant", lap)
    by_path["serve_router"] = (phase_serve_router(dev, card), 128, None)
    lap = lap_clock("serve_router", lap)
    by_path["serve_gemma3"] = (phase_serve_gemma3(dev, card), DIALECT_HEADS[GEMMA_PRESET][2],
                               GEMMA_PRESET)
    lap = lap_clock("serve_gemma3", lap)
    moe_launches, serve_rows, q8_launches = phase_serve_moe(dev, card)
    lap = lap_clock("serve_moe", lap)
    by_path["serve_moe"] = (moe_launches, 128, None)
    by_path["serve_moe_int8"] = (q8_launches, 128, None)
    table += serve_rows
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase clock: {time.perf_counter() - t0:.1f} s to the gpt-oss serving phase")
    gpt_oss_launches, serve_rows = phase_serve_gpt_oss(dev, card)
    by_path["serve_gpt_oss"] = (gpt_oss_launches, 64, GPT_OSS_LAYOUT)
    table += serve_rows
    gc.collect()
    torch.cuda.empty_cache()
    # the SFT path, after the serving phases (their host-bound ticks slow
    # down behind every trainer phase that runs before them): TinyLlama-1.1B
    # with LoRA (K1-K3 at D=64, the TinyLlama layout rows) and the
    # parameter-group leg, Qwen3-30B-A3B with LoRA on its experts (K1-K3 at
    # D=128 at the MoE layout, K4-K6 at 2048/768)
    log(f"phase clock: {time.perf_counter() - t0:.1f} s to the SFT phases")
    lap = time.perf_counter()
    by_path["sft_lora_dense"] = (phase_sft_lora_dense(dev, card), 64, None)
    lap = lap_clock("sft_lora_dense", lap)
    gc.collect()
    torch.cuda.empty_cache()
    by_path["sft_lora_moe"] = (phase_sft_lora_moe(dev, card), 128, None)
    lap = lap_clock("sft_lora_moe", lap)
    # the post-training trainers (DPO full and LoRA, distillation, RL) and
    # the channel loss: K1-K3 at D 128 (TinyLlama's LoRA leg at D 64)
    gc.collect()
    torch.cuda.empty_cache()
    by_path.update(phase_post_training(dev, card))
    lap = lap_clock("post_training", lap)
    # the vision-language trainer, after the serving phases for the same
    # reason: Qwen2-VL-2B and Qwen2.5-VL-3B (their K1-K3 rows at D 80 are
    # held and timed inside the phase, before its trainer)
    for phase in (phase_hf_trainer_qwen2_vl, phase_hf_trainer_qwen2_5_vl):
        gc.collect()
        torch.cuda.empty_cache()
        paths, rows = phase(dev, card)
        by_path.update(paths)
        table += rows
        lap = lap_clock(phase.__name__, lap)
    log(f"phase clock: {time.perf_counter() - t0:.1f} s to the end")

    for row in table:
        # a flash row counts the paths at its head dim and layout; a
        # grouped-GEMM row at widths no main path runs counts none
        counts = {path: (launches.get(row["name"], 0)
                         if row.get("head_dim", d) == d and row.get("on_main_path", True)
                         and row.get("path_layout") == layout else 0)
                  for path, (launches, d, layout) in by_path.items()}
        row["launches"] = sum(counts.values())
        row["launches_by_path"] = counts
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "launches_by_path")
    # flash K1-K3: head_dim and layout (what the row holds), single_segment_ms
    # (the like-for-like yardstick against SDPA), and for D=128 moe_layout
    # (the same numbers at Hq=32, Hkv=4 on the same batch) and
    # moe_micro_batch_1 (at Hq=32, Hkv=4 on its first row alone), for D=64
    # micro_batch_1; grouped GEMM K4-K6: k, n and layout
    extra = ("head_dim", "k", "n", "layout", "single_segment_ms", "moe_layout",
             "moe_micro_batch_1", "micro_batch_1", "ulysses_layout")
    print(json.dumps({"kernels": [{k: row[k] for k in keys + extra if k in row}
                                  for row in table]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
